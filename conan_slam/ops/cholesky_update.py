"""Cholesky-form Kalman measurement update — the hot kernel.

Reference: ``choleskyUpdate`` (slam.h:235-266) — the O(D^2 m + m^3) core that
both the EKF batch update (EKF.cpp:93-129) and the per-feature PF update
(PF.cpp:250-260) funnel into:

    PHT = P H^T
    S   = H PHT + R   (symmetrised)
    S   = L L^T
    W1  = PHT L^-T
    W   = W1 L^-1
    x  += W v
    P  -= W1 W1^T

The jnp implementation below compiles to three dense matmuls plus a small
Cholesky/triangular-solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.linalg import PRECISION, safe_cholesky, sym


def cholesky_update(x, p, v, r, h, *, jitter: float = 0.0,
                    return_nis: bool = False):
    """One Kalman update in Cholesky form.

    Args:
      x: (D,) state mean.
      p: (D, D) state covariance.
      v: (m,) innovation (already angle-wrapped; zero for masked rows).
      r: (m, m) measurement noise (identity blocks for masked rows).
      h: (m, D) stacked observation Jacobian (zero rows for masked rows).

    Returns (x', p'), or (x', p', nis) with ``return_nis`` where
    nis = v^T S^-1 v = ||L^-1 v||^2 (the stacked normalised innovation
    squared; masked rows contribute zero).  Masked rows contribute exactly
    nothing to the update: their H rows are zero, so the corresponding W1
    columns are zero and v is zero.
    """
    pht = jnp.matmul(p, h.T, precision=PRECISION)
    s = sym(jnp.matmul(h, pht, precision=PRECISION) + r)
    chol = safe_cholesky(s, jitter)
    # W1 = PHT L^-T via an explicit small L^-1 then one dense matmul
    # (instead of a triangular solve with a D-wide right-hand side).
    eye_m = jnp.eye(s.shape[-1], dtype=s.dtype)
    linv = jax.scipy.linalg.solve_triangular(chol, eye_m, lower=True)
    w1t = jnp.matmul(linv, pht.T, precision=PRECISION)
    # W = W1 L^-1; x += W v  <=>  x += W1 (L^-1 v).
    lv = jnp.matmul(linv, v, precision=PRECISION)
    x_new = x + jnp.matmul(w1t.T, lv, precision=PRECISION)
    p_new = sym(p - jnp.matmul(w1t.T, w1t, precision=PRECISION))
    if return_nis:
        return x_new, p_new, jnp.dot(lv, lv, precision=PRECISION)
    return x_new, p_new


def joseph_update(x, p, v, r, h):
    """Joseph-form update, used for the heading pseudo-observation.

    Reference: ``josephUpdate`` (slam.h:700-725):
        W = P H^T (H P H^T + R)^-1
        x += W v
        P  = (I - W H) P (I - W H)^T + W R W^T
    """
    pht = jnp.matmul(p, h.T, precision=PRECISION)
    s = sym(jnp.matmul(h, pht, precision=PRECISION) + r)
    w = jnp.linalg.solve(s, pht.T).T
    x_new = x + jnp.matmul(w, v, precision=PRECISION)
    c = jnp.eye(p.shape[0], dtype=p.dtype) - jnp.matmul(w, h, precision=PRECISION)
    p_new = sym(
        jnp.matmul(jnp.matmul(c, p, precision=PRECISION), c.T, precision=PRECISION)
        + jnp.matmul(jnp.matmul(w, r, precision=PRECISION), w.T,
                     precision=PRECISION)
    )
    return x_new, p_new


def joseph_update_scalar(x, p, v, r_scalar, idx: int):
    """Rank-1 Joseph update for a single direct state observation x[idx].

    Specialisation of ``joseph_update`` for H = e_idx^T (the heading
    observation, reference EKF.cpp:328-352): O(D^2) elementwise work with no
    D x D matmuls.  Algebraically:
        pc  = P[:, idx];  s = P[idx, idx] + r
        w   = pc / s
        x  += w v
        P   = P - w pc^T - pc w^T + (P[idx,idx] + r) w w^T
    (the Joseph form collapses to this for a 1-D exact-row observation).
    """
    pc = p[:, idx]
    s = p[idx, idx] + r_scalar
    w = pc / s
    x_new = x + w * v
    # C P C^T + r w w^T with C = I - w e^T:
    #   P - w pc^T - pc w^T + P[idx,idx] w w^T + r w w^T.
    outer_wpc = jnp.outer(w, pc)
    p_new = sym(p - outer_wpc - outer_wpc.T + s * jnp.outer(w, w))
    return x_new, p_new
