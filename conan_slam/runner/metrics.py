"""Trajectory and consistency metrics.

The reference has no metrics at all — "verification" is a human reading
stdout (test/main.cpp:134-137; SURVEY.md section 4).  These are the explicit
automated oracles: ATE against ground truth (the BASELINE.json accuracy
metric), plus filter-consistency statistics.
"""

from __future__ import annotations

import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import mm


def ate_rmse(x_true, x_est, valid=None):
    """Absolute trajectory error (position RMSE) over a run.

    Args:
      x_true, x_est: (T, 3) pose trajectories.
      valid: optional (T,) bool — steps to include (pre-``done`` steps).
    """
    err2 = jnp.sum((x_true[:, :2] - x_est[:, :2]) ** 2, axis=-1)
    if valid is None:
        return jnp.sqrt(jnp.mean(err2))
    w = valid.astype(err2.dtype)
    return jnp.sqrt(jnp.sum(err2 * w) / jnp.maximum(jnp.sum(w), 1.0))


def aligned_ate_rmse(x_true, x_est, valid=None):
    """ATE after optimal SE(2) alignment of the estimate to the truth.

    The standard ATE protocol (Horn/Umeyama closed form, rotation+translation,
    no scale): relative-only estimators (pose graphs without absolute
    anchoring) are evaluated up to a global rigid transform.
    """
    w = (valid if valid is not None else jnp.ones(x_true.shape[0], bool)).astype(
        x_true.dtype
    )
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    pt = x_true[:, :2]
    pe = x_est[:, :2]
    mu_t = jnp.sum(pt * w[:, None], axis=0) / wsum
    mu_e = jnp.sum(pe * w[:, None], axis=0) / wsum
    ct = pt - mu_t
    ce = pe - mu_e
    # Cross-covariance; optimal rotation from its polar angle.
    sxx = jnp.sum(w * ce[:, 0] * ct[:, 0])
    syy = jnp.sum(w * ce[:, 1] * ct[:, 1])
    sxy = jnp.sum(w * ce[:, 0] * ct[:, 1])
    syx = jnp.sum(w * ce[:, 1] * ct[:, 0])
    theta = jnp.arctan2(sxy - syx, sxx + syy)
    c, s = jnp.cos(theta), jnp.sin(theta)
    rot = jnp.asarray([[c, -s], [s, c]])
    aligned = mm(ce, rot.T) + mu_t
    err2 = jnp.sum((aligned - pt) ** 2, axis=-1)
    return jnp.sqrt(jnp.sum(err2 * w) / wsum)


def rpe_rmse(x_true, x_est, delta: int, valid=None):
    """Relative pose error (translational RMSE) over a horizon of ``delta``
    steps: || (p_est[t+d] - p_est[t]) rotated into est frame t  minus the
    same relative motion of the truth ||.

    The standard drift metric: unlike ATE it is invariant to the global
    gauge (rotation/translation), so it isolates the *internal* trajectory
    consistency that pose-graph relaxation acts on.
    """
    def rel(x):
        c = jnp.cos(x[:-delta, 2])
        s = jnp.sin(x[:-delta, 2])
        d = x[delta:, :2] - x[:-delta, :2]
        return jnp.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1]], axis=-1)

    err2 = jnp.sum((rel(x_true) - rel(x_est)) ** 2, axis=-1)
    if valid is None:
        return jnp.sqrt(jnp.mean(err2))
    w = jnp.logical_and(valid[:-delta], valid[delta:]).astype(err2.dtype)
    return jnp.sqrt(jnp.sum(err2 * w) / jnp.maximum(jnp.sum(w), 1.0))


def heading_rmse(x_true, x_est, valid=None):
    err2 = wrap_angle(x_true[:, 2] - x_est[:, 2]) ** 2
    if valid is None:
        return jnp.sqrt(jnp.mean(err2))
    w = valid.astype(err2.dtype)
    return jnp.sqrt(jnp.sum(err2 * w) / jnp.maximum(jnp.sum(w), 1.0))


def map_rmse(landmarks_true, features_est, active_mask, table):
    """RMSE of estimated landmark positions over active slots.

    ``table`` maps landmark id -> slot, so each active slot is compared with
    the ground-truth landmark that founded it.
    """
    num_ids = table.shape[0]
    slot_of_id = table  # (num_ids,)
    has_slot = slot_of_id >= 0
    est = features_est[jnp.clip(slot_of_id, 0, features_est.shape[0] - 1)]
    err2 = jnp.sum((est - landmarks_true) ** 2, axis=-1)
    w = has_slot.astype(err2.dtype)
    return jnp.sqrt(jnp.sum(err2 * w) / jnp.maximum(jnp.sum(w), 1.0))
