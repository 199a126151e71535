"""Trajectory/map visualisation.

The reference ships no visualizer ("no support for visualizer",
reference README.md:14) — its screenshot came from external tooling.  This
module provides the missing piece: a matplotlib plot of ground truth vs
estimate, the landmark map, and (optionally) covariance ellipses.
"""

from __future__ import annotations

import numpy as np


def _ellipse_path(mean, cov2, n_sigma: float = 2.0, n_pts: int = 40):
    """(n_pts, 2) polyline of the ``n_sigma`` covariance ellipse of a 2x2
    block: the unit circle mapped through n_sigma * chol(cov)."""
    cov2 = np.asarray(cov2, np.float64)
    cov2 = 0.5 * (cov2 + cov2.T)
    # Guard indefinite float blocks (eigval clip instead of raw cholesky).
    w, vec = np.linalg.eigh(cov2)
    w = np.clip(w, 0.0, None)
    l = vec * np.sqrt(w)[None, :]
    ang = np.linspace(0.0, 2.0 * np.pi, n_pts)
    circ = np.stack([np.cos(ang), np.sin(ang)])
    return np.asarray(mean)[None, :] + n_sigma * (l @ circ).T


def plot_run(
    x_true,
    x_est,
    landmarks=None,
    features=None,
    active_mask=None,
    valid=None,
    p=None,
    ellipse_stride: int = 1,
    n_sigma: float = 2.0,
    title: str = "conan_slam valet loop",
    save_path: str | None = None,
):
    """Plot a simulation run.  Returns the matplotlib figure.

    Args:
      x_true, x_est: (T, 3) trajectories.
      landmarks: optional (N, 2) ground-truth landmark positions.
      features: optional (K, 2) estimated feature positions.
      active_mask: optional (K,) bool for valid features.
      valid: optional (T,) bool step mask.
      p: optional (D, D) joint covariance (D = 3 + 2K) — draws the
         ``n_sigma`` pose-position ellipse at the trajectory end and one
         ellipse per active feature (every ``ellipse_stride``-th).
      save_path: if given, also writes a PNG.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x_true = np.asarray(x_true)
    x_est = np.asarray(x_est)
    if valid is not None:
        v = np.asarray(valid)
        x_true, x_est = x_true[v], x_est[v]

    fig, ax = plt.subplots(figsize=(9, 8))
    if landmarks is not None:
        lm = np.asarray(landmarks)
        ax.plot(lm[:, 0], lm[:, 1], "k*", ms=8, alpha=0.5, label="landmarks (true)")
    if features is not None:
        f = np.asarray(features)
        mask_np = (
            np.asarray(active_mask)
            if active_mask is not None
            else np.ones((f.shape[0],), bool)
        )
        fa = f[mask_np]
        ax.plot(fa[:, 0], fa[:, 1], "rx", ms=6, label="landmarks (est)")
        if p is not None:
            pm = np.asarray(p)
            first = True
            for k in np.flatnonzero(mask_np)[::max(1, ellipse_stride)]:
                blk = pm[3 + 2 * k: 5 + 2 * k, 3 + 2 * k: 5 + 2 * k]
                path = _ellipse_path(f[k], blk, n_sigma)
                ax.plot(
                    path[:, 0], path[:, 1], "r-", lw=0.6, alpha=0.5,
                    label=f"{n_sigma:g}-sigma (features)" if first else None,
                )
                first = False
    if p is not None and x_est.shape[0]:
        path = _ellipse_path(x_est[-1, :2], np.asarray(p)[:2, :2], n_sigma)
        ax.plot(
            path[:, 0], path[:, 1], "b-", lw=1.0, alpha=0.8,
            label=f"{n_sigma:g}-sigma (pose)",
        )
    ax.plot(x_true[:, 0], x_true[:, 1], "g-", lw=1.5, label="trajectory (true)")
    ax.plot(x_est[:, 0], x_est[:, 1], "b--", lw=1.0, label="trajectory (est)")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend(loc="best")
    ax.axis("equal")
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig
