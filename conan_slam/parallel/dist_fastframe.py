"""Distributed rank-compounded frame: the fastframe design on a sharded P.

Dispatching the reference's hot loop shape — 6 × (predict + heading)
sub-steps plus a batched update per observation frame
(test/main.cpp:132-200) — one sub-step at a time pays per-sub-step dispatch
and serialisation (filters.ekf.fastframe).  The legacy distributed runner
had that form: 6 × (sharded_predict + sharded_observe_heading), each a
shard_map with its own pose psum, plus separate update and augment
dispatches.

This module ports the rank-compounded frame to the row-block-sharded
covariance.  The enabling fact is that the frame compounding
(filters.ekf.fastframe.coeff_frame_core) reads only O(1) frame-start state —
the pose and the first three entries of the column P e2 — and emits the
whole frame's covariance effect as coefficient columns against P e2.  On a
row-sharded P every shard can therefore build its local slice of the frame
factor strip from its resident rows, and the entire frame (S sub-steps +
observe + batched Schur-style measurement update) collapses to ONE shard_map
kernel with exactly three collective rounds:

  1. one tiled all-gather of the stacked (2, Dp) [x, P e2] strip
     (the frame inputs: pose, feature positions, the tracked column);
  2. one psum of the (3 + 2NZ, 2NZ) measurement-row strip of P'H^T
     (the Schur complement's cross term — O(m^2), not O(m·Dp));
  3. one tiled all-gather of the (2NZ, Dp) whitened-gain strip for the
     local symmetric downdates — the m·Dp wire term that dominates the
     audited per-frame bytes (benchmarks/audit_collectives.py), now the
     ONLY O(Dp) collective in the frame.

Equivalence with the single-device fused frame is exact in real arithmetic
(same algebra, re-bracketed) and validated to float32 tolerance in
tests/test_parallel.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import PRECISION, sym
from conan_slam.filters.ekf.fastframe import coeff_frame_core
from conan_slam.models import sensor
from conan_slam.parallel.mesh import STATE_AXIS


def sharded_frame_update(
    mesh,
    x,              # (Dp,) row-sharded padded mean
    p,              # (Dp, Dp) row-block-sharded padded covariance
    vns, swans, phis, actives,   # (S,) per-sub-step controls (replicated)
    q_cov,          # (2, 2) filter control noise
    z,              # (NZ, 2) measurement buffer (replicated)
    slots,          # (NZ,) int32 map slots (replicated, clipped to capacity)
    mask,           # (NZ,) bool associated-and-live
    r_cov,          # (2, 2) filter observation noise
    wheel_base, dt, sigma_heading,
    use_heading: bool,
    axis: str = STATE_AXIS,
    gain_wire: str = "f32",
):
    """One whole observation frame on the sharded joint state.

    Semantically identical to filters.ekf.update.fused_frame_step (S
    predict+heading sub-steps compounded into a rank-(2+3S) factor, folded
    into the batched Cholesky-form measurement update; reference hot loop
    test/main.cpp:132-200) against the unsharded state.

    ``gain_wire`` selects the wire format of the (m, Dp) whitened-gain
    all-gather — 88% of the frame's collective bytes (PARITY.md audit):

      "f32" (default): exact; dist tests float32-match the fused frame.
      "i16": per-row-scaled int16 — HALVES the dominant wire term.  The
          strip is quantised against a psum'd global row max and BOTH sides
          of the downdate use the DECODED values, so the downdate stays a
          symmetric (PSD) Gram product — the asymmetric-feedback failure
          mode of lossy covariance arithmetic (round-2/round-4 lessons)
          is excluded by construction.  Element error <= rowmax/65534
          (~1.5e-5 of row scale, split3-tier), far below bf16's 4e-3.
          The mean correction keeps the exact local strip (no wire).

    Returns ``(x, p, nis, pose_trace)`` with ``nis`` the frame NIS per
    associated measurement and ``pose_trace`` the (S, 3) per-sub-step pose
    means (both replicated).
    """
    dp = x.shape[0]
    n_shards = mesh.shape[axis]
    chunk = dp // n_shards
    nz = z.shape[0]
    m = 2 * nz
    dtype = p.dtype

    from conan_slam.core.linalg import chol2

    q_chol = chol2(q_cov)
    rows2 = (3 + 2 * slots[:, None] + jnp.arange(2)[None, :]).reshape(-1)
    rows131 = jnp.concatenate([jnp.arange(3, dtype=rows2.dtype), rows2])

    def kernel(x_l, p_l):
        i = jax.lax.axis_index(axis)
        row_ids = i * chunk + jnp.arange(chunk)

        # --- collective 1: the frame inputs.  x (for pose + feature
        # positions) and the tracked column P e2, stacked into one gather. ---
        p2_l = p_l[:, 2]
        xp2 = jax.lax.all_gather(
            jnp.stack([x_l, p2_l]), axis, axis=1, tiled=True
        )                                                   # (2, Dp)
        x0_full, p2_full = xp2[0], xp2[1]

        # --- frame compounding: O(S) scalar work, replicated ---
        pose, pose_trace, corr0, cmat, bmat = coeff_frame_core(
            x0_full[:3], p2_full[:3], p2_full[2],
            vns, swans, phis, actives,
            q_chol, wheel_base, dt, sigma_heading, use_heading,
        )

        # Post-frame mean, replicated view (for the measurement operator).
        xq_full = x0_full + jnp.where(
            jnp.arange(dp) >= 3, p2_full * corr0, 0.0
        )
        xq_full = xq_full.at[:3].set(pose)
        xf = xq_full[rows2].reshape(nz, 2)

        # --- observation model at the post-frame mean (replicated) ---
        zp, hv, hf = sensor.observe(pose, xf)
        hv = jnp.where(mask[:, None, None], hv, 0.0)        # (NZ, 2, 3)
        hf = jnp.where(mask[:, None, None], hf, 0.0)        # (NZ, 2, 2)
        dz = z - zp
        v = jnp.stack([dz[:, 0], wrap_angle(dz[:, 1])], axis=-1)
        v = jnp.where(mask[:, None], v, 0.0).reshape(m)
        hv2 = hv.reshape(m, 3)

        # --- local slice of the frame factor strip V (chunk, NB) ---
        vloc = p2_l[:, None] * cmat[0][None, :]
        for rr in range(3):
            vloc = vloc + jnp.where(
                (row_ids == rr)[:, None], cmat[1 + rr][None, :], 0.0
            )

        # H V (m, NB): H p2 via the sparse pose/slot columns, plus the
        # e-basis rows (H's pose block against cmat's e-coefficients).
        hp2 = jnp.matmul(hv2, p2_full[:3], precision=PRECISION) + jnp.einsum(
            "nab,nb->na", hf, p2_full[rows2].reshape(nz, 2),
            precision=PRECISION,
        ).reshape(m)
        hvm = hp2[:, None] * cmat[0][None, :] + jnp.matmul(
            hv2, cmat[1:4], precision=PRECISION
        )                                                   # (m, NB)

        # --- P' H^T local row strip: P H^T (sparse H) + V B (H V)^T ---
        pcols = p_l[:, rows2].reshape(chunk, nz, 2)
        pht_l = (
            jnp.matmul(p_l[:, :3], hv2.T, precision=PRECISION)
            + jnp.einsum("cnk,nmk->cnm", pcols, hf,
                         precision=PRECISION).reshape(chunk, m)
            + jnp.matmul(
                vloc, jnp.matmul(bmat, hvm.T, precision=PRECISION),
                precision=PRECISION,
            )
        )                                                   # (chunk, m)

        # --- collective 2: measurement rows of P'H^T (pose + slot rows) ---
        local131 = rows131 - i * chunk
        inshard = jnp.logical_and(local131 >= 0, local131 < chunk)
        strip_part = jnp.where(
            inshard[:, None],
            pht_l[jnp.clip(local131, 0, chunk - 1)],
            0.0,
        )                                                   # (3 + m, m)
        strip = jax.lax.psum(strip_part, axis)

        # S = H P'H^T + R from the replicated strip.
        s = jnp.matmul(hv2, strip[:3], precision=PRECISION)
        strip_slots = strip[3:].reshape(nz, 2, m)
        s = s + jnp.einsum(
            "nab,nbm->nam", hf, strip_slots, precision=PRECISION
        ).reshape(m, m)
        eye2 = jnp.eye(2, dtype=dtype)
        rblocks = jnp.where(mask[:, None, None], r_cov, eye2)
        idx = jnp.arange(nz)
        s = s.reshape(nz, 2, nz, 2).at[idx, :, idx, :].add(rblocks)
        s = sym(s.reshape(m, m))

        # S^-1 (ops.spd_inverse), replicated on every shard: the same
        # structure as the single-device path
        # (filters.ekf.update.fused_frame_update).
        from conan_slam.ops.spd_inverse import spd_inverse

        si = spd_inverse(s)                                 # (m, m)
        siv = jnp.matmul(si, v, precision=PRECISION)
        nis = jnp.dot(v, siv, precision=PRECISION) / jnp.maximum(
            jnp.sum(mask.astype(dtype)), 1.0
        )

        # --- mean: post-frame local mean + measurement correction ---
        xq_l = x_l + jnp.where(row_ids >= 3, p2_l * corr0, 0.0)
        xq_l = jnp.where(
            row_ids < 3,
            pose[jnp.clip(row_ids, 0, 2)],
            xq_l,
        )
        x_new = xq_l + jnp.matmul(pht_l, siv, precision=PRECISION)
        x_new = jnp.where(
            row_ids == 2, wrap_angle(x_new), x_new
        )

        # --- collective 3: the P'H^T strip; then ONE local pass over the
        # resident covariance block: down = pht^T S^-1 pht with BOTH sides
        # taken from the (possibly decoded) gathered strip, so the downdate
        # stays exactly symmetric across shards ---
        if gain_wire == "i16":
            amax = jax.lax.pmax(
                jnp.max(jnp.abs(pht_l), axis=0), axis
            )                                               # (m,) global
            scale = jnp.maximum(amax, 1e-30) * (1.0 / 32767.0)
            q_l = jnp.round(pht_l.T / scale[:, None]).astype(jnp.int16)
            q_full = jax.lax.all_gather(q_l, axis, axis=1, tiled=True)
            pht_full = q_full.astype(dtype) * scale[:, None]
            pht_down_l = (q_l.astype(dtype) * scale[:, None]).T
        else:
            pht_full = jax.lax.all_gather(
                pht_l.T, axis, axis=1, tiled=True
            )                                               # (m, Dp)
            pht_down_l = pht_l
        vtf_full = cmat[0][:, None] * p2_full[None, :]      # (NB, Dp)
        vtf_full = vtf_full.at[:, :3].add(cmat[1:4].T)
        p_new = (
            p_l
            + jnp.matmul(
                vloc, jnp.matmul(bmat, vtf_full, precision=PRECISION),
                precision=PRECISION,
            )
            - jnp.matmul(
                jnp.matmul(pht_down_l, si, precision=PRECISION),
                pht_full, precision=PRECISION,
            )
        )
        return x_new, p_new, nis, pose_trace

    # nis / pose_trace are replicated by construction (derived from the
    # psum'd strip and the all-gathered frame inputs); the static VMA
    # checker cannot infer that through the closed-over control arrays.
    return shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis, None)),
        out_specs=(P(axis), P(axis, None), P(), P()),
        check_vma=False,
    )(x, p)
