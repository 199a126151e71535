"""EKF measurement update: batched and sequential forms.

Reference: ``EKF::batchUpdate`` (EKF.cpp:93-129), ``EKF::singleUpdate``
(EKF.cpp:457-479) and the dispatching ``EKF::update`` (EKF.cpp:481-496).
The batch form stacks all associated measurements into one joint Cholesky
update (one chain of dense matmuls); the sequential form reproduces the
order-dependent per-measurement semantics with a ``lax.scan``
(SURVEY.md section 7.3 item 2: don't silently parallelise where results
differ).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import PRECISION, sym
from conan_slam.filters.common import CompactObs
from conan_slam.filters.ekf.fastframe import frame_factors
from conan_slam.filters.ekf.observe import build_batch_operator
from conan_slam.filters.ekf.state import EKFState
from conan_slam.models import sensor
from conan_slam.ops.cholesky_update import cholesky_update
from conan_slam.ops.rank_update import rank_update_t
from conan_slam.ops.spd_inverse import spd_inverse


def batch_update(state: EKFState, obs: CompactObs, slots, mask, r_cov,
                 *, return_nis: bool = False):
    """Joint update over all associated measurements (reference EKF.cpp:93-129)."""
    v, h, rr = build_batch_operator(state, obs, slots, mask, r_cov)
    out = cholesky_update(state.x, state.p, v, rr, h, return_nis=return_nis)
    x, p = out[:2]
    x = x.at[2].set(wrap_angle(x[2]))
    new_state = state._replace(x=x, p=p)
    if return_nis:
        return new_state, out[2]
    return new_state


def sequential_update(state: EKFState, obs: CompactObs, slots, mask, r_cov,
                      *, return_nis: bool = False):
    """Per-measurement updates in buffer order (reference EKF.cpp:457-479)."""
    d = state.x.shape[0]
    cap = state.capacity

    def body(carry, inp):
        x, p = carry
        z_i, slot_i, m_i = inp
        xf = jax.lax.dynamic_slice(x, (3 + 2 * slot_i,), (2,))
        zp, hv, hf = sensor.observe(x[:3], xf)
        v = jnp.stack([z_i[0] - zp[0], wrap_angle(z_i[1] - zp[1])])
        v = jnp.where(m_i, v, 0.0)
        h = jnp.zeros((2, d), dtype=p.dtype)
        h = h.at[:, :3].set(hv)
        h = jax.lax.dynamic_update_slice(h, hf, (0, 3 + 2 * slot_i))
        h = jnp.where(m_i, h, 0.0)
        r = jnp.where(m_i, r_cov, jnp.eye(2, dtype=p.dtype))
        x, p, nis_i = cholesky_update(x, p, v, r, h, return_nis=True)
        return (x, p), nis_i

    safe_slots = jnp.clip(slots, 0, cap - 1)
    (x, p), nis_seq = jax.lax.scan(
        body, (state.x, state.p), (obs.z, safe_slots, mask)
    )
    x = x.at[2].set(wrap_angle(x[2]))
    new_state = state._replace(x=x, p=p)
    if return_nis:
        return new_state, jnp.sum(nis_seq)
    return new_state


def update(state: EKFState, obs: CompactObs, slots, mask, r_cov, batch: bool,
           *, return_nis: bool = False):
    """Dispatch on the batch switch (reference EKF.cpp:481-496); ``batch`` is
    static config, so only one path is compiled."""
    if batch:
        return batch_update(state, obs, slots, mask, r_cov,
                            return_nis=return_nis)
    return sequential_update(state, obs, slots, mask, r_cov,
                             return_nis=return_nis)


def fused_frame_step(
    state: EKFState, vns, swans, phis, actives, q_cov, obs: CompactObs,
    slots, mask, r_cov, wheel_base, dt, sigma_heading, use_heading: bool,
):
    """Known-association whole frame: S predict+heading sub-steps, observe,
    measurement update, with P rewritten once.

    ``frame_factors`` (the factor recursion) followed by
    ``fused_frame_update``.  Returns
    ``(new_state, pose_trace (S, 3), nis_per_measurement)``.
    """
    state1, pose_trace, vmat, bmat = frame_factors(
        state, vns, swans, phis, actives, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    state2, nis = fused_frame_update(
        state1, vmat, bmat, obs, slots, mask, r_cov, return_nis=True,
    )
    return state2, pose_trace, nis


def fused_frame_update(
    state: EKFState, vmat, bmat, obs: CompactObs, slots, mask, r_cov,
    *, return_nis: bool = False,
):
    """Frame-factored batch update: ONE rewrite of P per observation frame.

    ``state.p`` is the frame-START covariance; the frame's predict+heading
    effect is the factored correction ``vmat bmat vmat^T``
    (filters.ekf.fastframe.frame_factors).  The measurement update operates
    against the *virtual* covariance P' = P + V B V^T without materialising
    it:

        P' H^T = P H^T + V (B (V^T H^T))           (cheap: D x r extra)
        S      = H (P'H^T) + R;  S^-1 (ops.spd_inverse)
        P_new  = P + V B V^T - (P'H^T) S^-1 (P'H^T)^T   (ops.rank_update)

    Masked measurements contribute nothing (zero H rows / identity R),
    so this runs unconditionally — a frame with no associated measurement
    degenerates to applying the factored correction alone.

    The measurement downdate folds into the factored rank update as a
    -S^-1 middle block, so P is read and written exactly once for the whole
    frame.  The operator itself is never materialised: H touches only the 3
    pose columns and the 2 columns of each measured slot, so P H'^T is
    assembled from a (2NZ, D) *row gather* of the symmetric P (plus the
    factored V B V^T correction) instead of a dense (D, D) x (D, 2NZ) matmul.
    """
    d = state.x.shape[0]
    nz = obs.z.shape[0]
    cap = state.capacity
    safe = jnp.clip(slots, 0, cap - 1)
    rows2 = (3 + 2 * safe[:, None] + jnp.arange(2)[None, :]).reshape(-1)

    xf = state.features[safe]                                    # (NZ, 2)
    zp, hv, hf = sensor.observe(state.pose, xf)
    hv = jnp.where(mask[:, None, None], hv, 0.0)                 # (NZ, 2, 3)
    hf = jnp.where(mask[:, None, None], hf, 0.0)                 # (NZ, 2, 2)
    dz = obs.z - zp
    v = jnp.stack([dz[:, 0], wrap_angle(dz[:, 1])], axis=-1)
    v = jnp.where(mask[:, None], v, 0.0).reshape(2 * nz)

    # --- phtT = H (P + V B V^T) as (2NZ, D) row strips ---
    prow_pose = state.p[:3, :]                                   # (3, D)
    prow_slot = state.p[rows2, :].reshape(nz, 2, d)              # row gather
    hv2 = hv.reshape(2 * nz, 3)
    phtT = jnp.matmul(hv2, prow_pose, precision=PRECISION) + jnp.sum(
        hf[:, :, :, None] * prow_slot[:, None, :, :], axis=2
    ).reshape(2 * nz, d)
    # Factored correction: (H V) B V^T.
    hvm = jnp.matmul(hv2, vmat[:3, :], precision=PRECISION) + jnp.sum(
        hf[:, :, :, None] * vmat[rows2, :].reshape(nz, 2, -1)[:, None, :, :],
        axis=2,
    ).reshape(2 * nz, -1)                                        # (2NZ, r)
    phtT = phtT + jnp.matmul(
        jnp.matmul(hvm, bmat, precision=PRECISION), vmat.T, precision=PRECISION
    )

    # --- S = phtT H^T + R: H^T touches the same pose/slot columns ---
    s = jnp.matmul(phtT[:, :3], hv2.T, precision=PRECISION)      # (2NZ, 2NZ)
    ph_slot = phtT[:, rows2].reshape(2 * nz, nz, 2)
    s = s + jnp.sum(
        ph_slot[:, :, None, :] * hf[None, :, :, :], axis=3
    ).reshape(2 * nz, 2 * nz)
    eye2 = jnp.eye(2, dtype=s.dtype)
    rblocks = jnp.where(mask[:, None, None], r_cov, eye2)        # (NZ, 2, 2)
    idx = jnp.arange(nz)
    s = s.reshape(nz, 2, nz, 2).at[idx, :, idx, :].add(rblocks).reshape(
        2 * nz, 2 * nz
    )
    s = sym(s)

    si = spd_inverse(s)                                          # (2NZ, 2NZ)
    siv = jnp.matmul(si, v, precision=PRECISION)
    x = state.x + jnp.matmul(siv, phtT, precision=PRECISION)
    x = x.at[2].set(wrap_angle(x[2]))

    # P <- P + [V PHT] [[B, 0], [0, -S^-1]] [V PHT]^T in one pass.  The
    # product stays at full fp32 (core.linalg.PRECISION): mapping from
    # scratch collapses a fresh landmark's ~35 m prior to ~0.1 m in one
    # observation, so a product error of 2^-16 of the operands already
    # exceeds the posterior and turns variances negative, and the gates flip
    # on sub-percent covariance error (PARITY.md, "Gated-path precision").
    nb = bmat.shape[0]
    m = s.shape[0]
    vt = jnp.concatenate([vmat.T, phtT], axis=0)                 # (nb+2NZ, D)
    bbig = jnp.zeros((nb + m, nb + m), dtype=bmat.dtype)
    bbig = bbig.at[:nb, :nb].set(bmat)
    bbig = bbig.at[nb:, nb:].set(-si)
    p = rank_update_t(state.p, vt, bbig)
    new_state = state._replace(x=x, p=p)
    if return_nis:
        # v^T S^-1 v: the stacked NIS, normalised per associated measurement
        # (a chi^2_2 consistency statistic).
        n_meas = jnp.maximum(jnp.sum(mask.astype(v.dtype)), 1.0)
        return new_state, jnp.dot(v, siv, precision=PRECISION) / n_meas
    return new_state
