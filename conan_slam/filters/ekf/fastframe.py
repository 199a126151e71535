"""Rank-compounded frame updates: the EKF's speed-of-light time update.

Motivation (memory roofline): per control step the reference-shaped
pipeline rewrites the full joint covariance twice for the heading
observation (rank-1 Joseph update, O(D^2) device-memory traffic) and touches strips for predict —
at 100 Hz control / ~20 Hz observations that is ~13 full passes over P per
observation frame.  But every per-step covariance transform in the frame has
the special structure

    predict:  P <- G P G^T + F F^T,      G = I + u e2^T   (u in span{e0,e1})
    heading:  P <- C P C^T + r w w^T,    C = I - w e2^T,  w = P e2 / s

i.e. *all* multiplicative factors are of the form (I + a e2^T), which is
closed under composition:  (I + a e2^T)(I + b e2^T) = I + (a(1+b_2) + b) e2^T.
Therefore the whole frame collapses to

    P_frame = P0 + [m  p2] [[beta, 1],[1, 0]] [m  p2]^T
                 + sum_k F'_k F'_k^T  +  sum_k r w'_k w'_k^T

a single symmetric rank-(2 + 3*interval) update, where every vector
(m, the transformed noise factors F'_k, the transformed gains w'_k) is
computable from O(D) tracking of the single column P e2 — the only part of P
the heading gain ever reads.  HBM traffic per frame drops from ~13 full
passes over P to one, and the mean corrections accumulate as
x += sum_k v_k w_k.

Sequential equivalence is exact in real arithmetic; float32 agreement is
validated against the step-by-step implementation in tests/test_fastframe.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import PRECISION
from conan_slam.filters.ekf.state import EKFState
from conan_slam.models import motion


def frame_predict_heading(
    state: EKFState,
    vns,            # (S,) noisy velocity per sub-step
    swans,          # (S,) noisy steering per sub-step
    phi_meas,       # (S,) true heading measurement per sub-step
    active,         # (S,) bool: sub-step executes (False once course done)
    q_cov,          # (2, 2) filter control noise
    wheel_base,
    dt,
    sigma_heading,
    use_heading: bool,
    return_pose_trace: bool = False,
):
    """Apply ``S`` (predict + heading-observe) sub-steps as one rank update.

    Equivalent to S iterations of filters.ekf.predict + observe_heading
    (reference EKF.cpp:406-455, 328-352) with identical inputs.  With
    ``return_pose_trace`` also returns the exact (S, 3) per-sub-step pose
    means (the pose is tracked exactly through the compounding).
    """
    x, pose_trace, vmat, bmat = _frame_core(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    p = state.p + jnp.matmul(
        jnp.matmul(vmat, bmat, precision=PRECISION),
        vmat.T,
        precision=PRECISION,
    )
    new_state = state._replace(x=x, p=p)
    if return_pose_trace:
        return new_state, pose_trace
    return new_state


def frame_factors(
    state: EKFState,
    vns, swans, phi_meas, active,
    q_cov, wheel_base, dt, sigma_heading, use_heading: bool,
):
    """Like ``frame_predict_heading`` but WITHOUT materialising P.

    Returns (state_with_updated_mean_and_STALE_P, pose_trace (S, 3),
    vmat (D, r), bmat (r, r)); the frame's covariance effect is
    P_frame = state.p + vmat bmat vmat^T.  Consumers fold the factors into
    the measurement update so P is rewritten exactly once per frame
    (filters.ekf.update.fused_frame_update + ops.rank_update).
    """
    x, pose_trace, vmat, bmat = _frame_core(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    return state._replace(x=x), pose_trace, vmat, bmat


def _frame_core(
    state: EKFState,
    vns, swans, phi_meas, active,
    q_cov, wheel_base, dt, sigma_heading, use_heading: bool,
):
    """Shared S-sub-step compounding; returns (x, pose_trace, vmat, bmat).

    Thin materialising wrapper over ``coeff_frame_core`` (which carries the
    actual recursion): applies the map mean correction and expands the
    coefficient columns against P0 e2 into the dense (D, r) factor matrix.
    """
    from conan_slam.core.linalg import chol2

    q_chol = chol2(q_cov)
    p2_0 = state.p[:, 2]
    pose, pose_trace, corr0, cmat, bmat = coeff_frame_core(
        state.pose, p2_0[:3], p2_0[2], vns, swans, phi_meas, active,
        q_chol, wheel_base, dt, sigma_heading, use_heading,
    )

    # Mean: map components get sum_k v_k w_k[0] * p2_0; the pose part was
    # tracked exactly through the compounding.  w_k's e-basis components only
    # touch rows 0:3, which are overwritten by the exact pose — only the p2_0
    # component survives.
    x = state.x
    if use_heading:
        x = x + (p2_0 * corr0).at[:3].set(0.0)
    x = x.at[:3].set(pose)

    # Coefficient columns -> ONE outer product against P0 e2 + 3 row writes.
    vmat = p2_0[:, None] * cmat[0][None, :]             # (D, nb)
    vmat = vmat.at[:3, :].add(cmat[1:, :])
    return x, pose_trace, vmat, bmat


def coeff_frame_core(
    pose0,          # (3,) frame-start pose mean
    p2_head,        # (3,) first three entries of the frame-start column P e2
    p22_0,          # ()   P[2, 2] at frame start
    vns, swans, phi_meas, active,
    q_chol, wheel_base, dt, sigma_heading, use_heading: bool,
):
    """The frame compounding in pure 4-coefficient space.

    Every D-vector the recursion produces (the tracked column P e2, heading
    gains w_k, composition vectors t_k, transformed noise factors) lies in
    span{P0 e2, e0, e1, e2} — the noise factors F_k only populate rows 0:3,
    u_k lies in span{e0, e1}, and w_k ∝ col2 which stays inside the span.
    So the whole per-sub-step recursion runs on 4-coefficient scalars; the
    only frame-start state it reads is the pose and (P e2)[:3] — O(1) data,
    which is what makes this form communication-free for a row-sharded P
    (parallel.dist_fastframe).

    Returns ``(pose, pose_trace (S, 3), corr0, cmat (4, NB), bmat (NB, NB))``
    where column j of ``cmat`` represents the factor vector
    ``p2_0 * cmat[0, j] + e0 * cmat[1, j] + e1 * cmat[2, j] + e2 * cmat[3, j]``
    and the frame covariance effect is ``P0 + V bmat V^T``; the map mean
    correction is ``x_map += p2_0 * corr0``.
    """
    s_steps = len(vns) if isinstance(vns, (list, tuple)) else vns.shape[0]
    dtype = pose0.dtype
    r_head = jnp.asarray(sigma_heading**2, dtype)

    pose = pose0

    # Coefficient vectors c represent p2_0*c[0] + e0*c[1] + e1*c[2] + e2*c[3].
    zero4 = jnp.zeros((4,), dtype)

    def val2(c):
        """Index-2 component of the represented vector."""
        return c[0] * p22_0 + c[3]

    def head3(c):
        """First three components of the represented vector."""
        return p2_head * c[0] + jnp.stack([c[1], c[2], c[3]])

    gamma = zero4.at[0].set(1.0)    # col2 = P e2 tracking
    a_list = []        # composition coefficients of (C_k G_k) = I + a_k e2^T
    f_list = []        # noise factor coefficients (4, 2) per sub-step
    b3_list = []       # raw (3, 2) noise blocks (for the f' row-2 term)
    w_list = []        # heading gain coefficients (4,)
    v_list = []        # heading innovations (scalars)
    pose_trace = []    # exact pose mean after each sub-step

    for k in range(s_steps):
        act = active[k]
        vn = vns[k]
        swan = swans[k]

        # --- predict ---
        gv, gu = motion.jacobians(pose, vn, swan, wheel_base, dt)
        # G = I + u e2^T with u = (Gv[0,2], Gv[1,2], 0, ...).
        u_c = zero4.at[1].set(gv[0, 2]).at[2].set(gv[1, 2])
        u_c = jnp.where(act, u_c, 0.0)
        b3 = jnp.where(act, jnp.matmul(gu, q_chol, precision=PRECISION), 0.0)
        f_c = jnp.zeros((4, 2), dtype).at[1:, :].set(b3)
        # col2 <- G col2 + (F F^T) e2  =  col2 + u col2[2] + F F[2,:]^T.
        gamma = gamma + u_c * val2(gamma) + jnp.matmul(
            f_c, b3[2, :], precision=PRECISION
        )
        pose_new = motion.step(pose, vn, swan, wheel_base, dt)
        pose = jnp.where(act, pose_new, pose)

        # --- heading observation ---
        if use_heading:
            c2 = val2(gamma)
            s_k = c2 + r_head
            w_c = jnp.where(act, gamma / s_k, 0.0)
            v = jnp.where(act, wrap_angle(phi_meas[k] - pose[2]), 0.0)
            # col2' = (1 - w2)(col2 - w col2[2]) + r w2 w.
            w2 = c2 / s_k
            gamma = jnp.where(
                act, (1.0 - w2) * (gamma - w_c * c2) + r_head * w2 * w_c, gamma
            )
            # Pose mean correction from this heading update (rows 0:3 of w).
            pose = pose + head3(w_c) * v
            pose = pose.at[2].set(wrap_angle(pose[2]))
            a_c = u_c - w_c   # (C G) = I + (u - w(1 + u_2)) e2^T, u_2 = 0.
        else:
            w_c = zero4
            v = jnp.asarray(0.0, dtype)
            a_c = u_c
        a_list.append(a_c)
        f_list.append(f_c)
        b3_list.append(b3)
        w_list.append(w_c)
        v_list.append(v)
        pose_trace.append(pose)

    # --- suffix composition: t_k = transform AFTER sub-step k (for w terms),
    #     composed with C_k for the F terms, m = full composition ---
    def compose(b, a):
        """(I + a e2^T)(I + b e2^T) -> coefficient a(1 + b_2) + b."""
        return a * (1.0 + val2(b)) + b

    t = [None] * s_steps
    acc = zero4
    for k in range(s_steps - 1, -1, -1):
        t[k] = acc
        acc = compose(a_list[k], acc)      # prepend (C_k G_k)
    m_c = acc

    # Transformed factors (still 4-coefficient space).
    w_prime = [w_list[k] + t[k] * val2(w_list[k]) for k in range(s_steps)]
    f_prime = []
    for k in range(s_steps):
        c_k = compose(-w_list[k], t[k]) if use_heading else t[k]
        f_prime.append(f_list[k] + jnp.outer(c_k, b3_list[k][2, :]))

    # --- map mean-correction coefficient (x_map += p2_0 * corr0) ---
    if use_heading:
        corr0 = sum(v_list[k] * w_list[k][0] for k in range(s_steps))
    else:
        corr0 = jnp.asarray(0.0, dtype)

    # --- covariance factor coefficient columns: [m, p2] + S F-pairs
    #     [+ S w vectors] ---
    c_cols = [m_c, zero4.at[0].set(1.0)]
    c_cols += [f_prime[k][:, i] for k in range(s_steps) for i in (0, 1)]
    if use_heading:
        c_cols += w_prime
    cmat = jnp.stack(c_cols, axis=1)                    # (4, 2 + 2S [+ S])
    nb = cmat.shape[1]
    bmat = jnp.zeros((nb, nb), dtype)
    bmat = bmat.at[0, 0].set(p22_0)
    bmat = bmat.at[0, 1].set(1.0)
    bmat = bmat.at[1, 0].set(1.0)
    for i in range(2, 2 + 2 * s_steps):
        bmat = bmat.at[i, i].set(1.0)
    if use_heading:
        for i in range(2 + 2 * s_steps, nb):
            bmat = bmat.at[i, i].set(r_head)

    return pose, jnp.stack(pose_trace), corr0, cmat, bmat
