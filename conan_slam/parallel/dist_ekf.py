"""Distributed EKF-SLAM: joint covariance sharded in row blocks over chips.

No reference analogue exists (the reference is single-threaded,
SURVEY.md section 2.2); scope set by BASELINE.json: shard the landmark
covariance in row blocks across the devices and reduce the joint update by
Schur-complement-style block elimination over collectives (NCCL over NVLink
on a multi-GPU host).

Layout: the padded joint state (Dp = 3 + 2K rounded up to the shard grain)
is split in contiguous row blocks across the ``state`` mesh axis:
``x``: P('state'), ``P``: P('state', None).  Measurement operators (m x Dp
Jacobian stacks, m small) are replicated.

The measurement update is the communication pattern from SURVEY.md
section 5.7: local PH^T strips, a psum'd m x m innovation-covariance
(the Schur complement of the sharded prior against the measurement block),
a replicated small Cholesky, and an all-gather of the m x Dp gain strip for
the local symmetric downdates — O(m * Dp) bytes on the wire per update
versus O(Dp^2) resident per chip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import PRECISION, safe_cholesky, sym
from conan_slam.models import motion
from conan_slam.parallel.mesh import STATE_AXIS, pad_to_multiple


def padded_dim(d: int, n_shards: int, grain: int = 8) -> int:
    """State dim padded so each shard's row block is a multiple of ``grain``."""
    return pad_to_multiple(d, n_shards * grain)


def shard_state(mesh, x, p, axis: str = STATE_AXIS):
    """Pad (x, P) to the shard grain and place with row-block shardings."""
    n = mesh.shape[axis]
    d = x.shape[0]
    dp = padded_dim(d, n)
    x_pad = jnp.zeros((dp,), x.dtype).at[:d].set(x)
    p_pad = jnp.zeros((dp, dp), p.dtype).at[:d, :d].set(p)
    x_sh = jax.device_put(x_pad, NamedSharding(mesh, P(axis)))
    p_sh = jax.device_put(p_pad, NamedSharding(mesh, P(axis, None)))
    return x_sh, p_sh


def _pose_from_shards(x_l, axis):
    """Broadcast the pose (rows 0:3, resident on shard 0) to all shards."""
    i = jax.lax.axis_index(axis)
    local_pose = jnp.where(i == 0, x_l[:3], 0.0)
    return jax.lax.psum(local_pose, axis)


def sharded_cholesky_update(mesh, x, p, v, r, h, axis: str = STATE_AXIS):
    """Cholesky-form KF update on a row-sharded covariance.

    Algebra identical to ops.cholesky_update (reference slam.h:235-266);
    collectives: one psum of the (m, m) partial S, one tiled all-gather of
    the (m, Dp) whitened-gain strip.
    """
    dp = x.shape[0]
    n = mesh.shape[axis]
    chunk = dp // n

    def kernel(x_l, p_l, v, r, h):
        i = jax.lax.axis_index(axis)
        pht_l = jnp.matmul(p_l, h.T, precision=PRECISION)          # (chunk, m)
        h_l = jax.lax.dynamic_slice_in_dim(h, i * chunk, chunk, axis=1)
        s_part = jnp.matmul(h_l, pht_l, precision=PRECISION)        # (m, m)
        s = sym(jax.lax.psum(s_part, axis) + r)
        chol = safe_cholesky(s)
        # Small explicit L^-1 + dense matmul (instead of a triangular solve
        # with a wide right-hand side); replicated, no extra communication.
        eye_m = jnp.eye(s.shape[0], dtype=s.dtype)
        linv = jax.scipy.linalg.solve_triangular(chol, eye_m, lower=True)
        w1t_l = jnp.matmul(linv, pht_l.T, precision=PRECISION)
        lv = jnp.matmul(linv, v, precision=PRECISION)
        x_new = x_l + jnp.matmul(w1t_l.T, lv, precision=PRECISION)
        w1t_full = jax.lax.all_gather(w1t_l, axis, axis=1, tiled=True)  # (m, dp)
        p_new = p_l - jnp.matmul(w1t_l.T, w1t_full, precision=PRECISION)
        return x_new, p_new

    return shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None), P(), P(), P()),
        out_specs=(P(axis), P(axis, None)),
    )(x, p, v, r, h)


def sharded_predict(mesh, x, p, v_ctrl, swa, q_cov, wheel_base, dt, axis: str = STATE_AXIS):
    """Structured motion prediction on the sharded covariance.

    Row strip (pose rows, shard 0 only) and column strip (all shards) are
    updated locally; the only collective is the 3-element pose broadcast.
    Mirrors filters.ekf.predict (reference EKF.cpp:406-455).
    """

    def kernel(x_l, p_l):
        i = jax.lax.axis_index(axis)
        pose = _pose_from_shards(x_l, axis)
        gv, gu = motion.jacobians(pose, v_ctrl, swa, wheel_base, dt)

        # Row strip: [Pvv | Pvm] <- Gv [Pvv | Pvm]   (shard 0 only).
        rows = jnp.matmul(gv, p_l[:3, :], precision=PRECISION)
        p_l = jnp.where(i == 0, p_l.at[:3, :].set(rows), p_l)
        # Column strip on every shard: cols 0:3 <- cols @ Gv^T.
        p_l = p_l.at[:, :3].set(jnp.matmul(p_l[:, :3], gv.T, precision=PRECISION))
        # Process noise into the pose block (shard 0).
        guq = jnp.matmul(jnp.matmul(gu, q_cov, precision=PRECISION), gu.T, precision=PRECISION)
        p_l = jnp.where(i == 0, p_l.at[:3, :3].add(guq), p_l)

        pose_new = motion.step(pose, v_ctrl, swa, wheel_base, dt)
        x_l = jnp.where(i == 0, x_l.at[:3].set(pose_new), x_l)
        return x_l, p_l

    return shard_map(
        kernel, mesh=mesh, in_specs=(P(axis), P(axis, None)), out_specs=(P(axis), P(axis, None))
    )(x, p)


def sharded_observation_update(
    mesh, x, p, z, slots, mask, r_cov, capacity: int, axis: str = STATE_AXIS
):
    """Full batched measurement update against the sharded state.

    The (2m, Dp) operator is assembled replicated — XLA gathers the O(Dp)
    mean once; the O(Dp^2) covariance never leaves its shards — then the
    Schur-style sharded Cholesky update runs.  Mirrors
    filters.ekf.update.batch_update (reference EKF.cpp:93-129).
    """
    dp = x.shape[0]
    pose = x[:3]
    features = jax.lax.dynamic_slice_in_dim(x, 3, 2 * capacity).reshape(capacity, 2)
    from conan_slam.filters.ekf.observe import assemble_operator

    v, h, rr = assemble_operator(pose, features, z, slots, mask, r_cov, dp)
    x_new, p_new = sharded_cholesky_update(mesh, x, p, v, rr, h, axis)
    return x_new, p_new


def sharded_augment(
    mesh, x, p, z, ids, new_mask, r_cov, n_active, table, axis: str = STATE_AXIS
):
    """Masked new-feature founding on the sharded state.

    Mirrors filters.ekf.augment (reference EKF.cpp:9-91).  Communication:
    one (3, Dp) pose-row-strip broadcast (psum from shard 0); every scatter
    is local, with out-of-range local indices dropped — each shard writes
    only the strip rows it owns, and all shards write the columns.

    Returns (x, p, n_active, table).
    """
    dp = x.shape[0]
    n = mesh.shape[axis]
    chunk = dp // n
    nz = z.shape[0]
    num_ids = table.shape[0]

    # Slot assignment (replicated bookkeeping, identical on all shards).
    rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    slots = n_active + rank
    cap = (dp - 3) // 2
    ok = jnp.logical_and(new_mask, slots < cap)
    row0 = jnp.where(ok, 3 + 2 * slots, dp)           # dp => dropped
    rows2 = jnp.stack([row0, row0 + 1], axis=1).reshape(-1)  # (2 NZ,)

    def kernel(x_l, p_l):
        i = jax.lax.axis_index(axis)
        pose = _pose_from_shards(x_l, axis)
        from conan_slam.models import sensor

        xf, gv, gz = sensor.init_feature(pose, z)     # (NZ,2) (NZ,2,3) (NZ,2,2)

        # Pose-row strip of P, broadcast from its owner (shard 0).
        strip = jax.lax.psum(
            jnp.where(i == 0, p_l[:3, :], 0.0), axis
        )                                              # (3, dp) full width
        new_rows = jnp.einsum("nab,bd->nad", gv, strip, precision=PRECISION)
        new_rows = jnp.where(ok[:, None, None], new_rows, 0.0).reshape(2 * nz, dp)

        pvv = strip[:, :3]
        cross = jnp.einsum("iab,bc,jdc->iajd", gv, pvv, gv, precision=PRECISION)
        diag_extra = jnp.einsum("iab,bc,idc->iad", gz, r_cov, gz, precision=PRECISION)
        idx = jnp.arange(nz)
        cross = cross.at[idx, :, idx, :].add(diag_extra).reshape(2 * nz, 2 * nz)

        # Local row indices: rows this shard owns, others dropped.
        local_rows = jnp.where(
            (rows2 >= i * chunk) & (rows2 < (i + 1) * chunk),
            rows2 - i * chunk,
            chunk,
        )
        # Rows (strip part): new feature rows across all columns.
        p_l = p_l.at[local_rows, :].set(new_rows, mode="drop")
        # Columns on every shard.
        p_l = p_l.at[:, rows2].set(
            jax.lax.dynamic_slice_in_dim(new_rows.T, i * chunk, chunk, axis=0),
            mode="drop",
        )
        # New-new cross blocks overwrite the intersections (row-owner shards).
        p_l = p_l.at[local_rows[:, None], rows2[None, :]].set(cross, mode="drop")

        # Mean scatter (owner shards).
        x_l = x_l.at[local_rows].set(
            jnp.where(ok[:, None], xf, 0.0).reshape(-1), mode="drop"
        )
        return x_l, p_l

    x_new, p_new = shard_map(
        kernel, mesh=mesh, in_specs=(P(axis), P(axis, None)), out_specs=(P(axis), P(axis, None))
    )(x, p)

    n_new = jnp.sum(ok.astype(jnp.int32))
    table_new = table.at[jnp.where(ok, ids, num_ids)].set(
        slots.astype(jnp.int32), mode="drop"
    )
    return x_new, p_new, n_active + n_new, table_new


def sharded_observe_heading(mesh, x, p, phi_meas, sigma_heading, axis: str = STATE_AXIS):
    """Rank-1 Joseph heading update on the sharded covariance
    (mirrors ops.joseph_update_scalar; reference EKF.cpp:328-352).

    Collectives: pose broadcast + one Dp-length all-gather of the P[:, 2]
    column strip.
    """
    r = sigma_heading**2

    def kernel(x_l, p_l):
        i = jax.lax.axis_index(axis)
        pose = _pose_from_shards(x_l, axis)
        v = wrap_angle(phi_meas - pose[2])
        pc_l = p_l[:, 2]                                   # local rows of P[:, 2]
        pc = jax.lax.all_gather(pc_l, axis, axis=0, tiled=True)   # (dp,)
        s = pc[2] + r
        w = pc / s
        chunk = x_l.shape[0]
        w_l = jax.lax.dynamic_slice_in_dim(w, i * chunk, chunk)
        x_new = x_l + w_l * v
        x_new = jnp.where(
            (i == 0), x_new.at[2].set(wrap_angle(x_new[2])), x_new
        )
        p_new = (
            p_l
            - jnp.outer(w_l, pc)
            - jnp.outer(pc_l, w)
            + s * jnp.outer(w_l, w)
        )
        return x_new, p_new

    return shard_map(
        kernel, mesh=mesh, in_specs=(P(axis), P(axis, None)), out_specs=(P(axis), P(axis, None))
    )(x, p)
