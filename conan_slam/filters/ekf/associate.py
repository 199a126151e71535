"""Data association: known-table and Mahalanobis-gated nearest neighbour.

Reference: ``EKF::dataAssociateTable`` (EKF.cpp:146-233) and
``EKF::dataAssociate`` / ``computeAssociation`` (EKF.cpp:235-326, 131-144).

Dense masked redesign: the reference compacts measurements into known (ZF) /
new (ZN) matrices and runs an O(nz * nf) scalar double loop; here association
is a dense masked computation — a (NZ, K) NIS matrix from batched 2x2 block
algebra, a masked argmin per measurement, and boolean known/new masks over the
fixed-size measurement buffer.  (The reference's gated path also has a dead
new-feature output, SURVEY.md defect 4 — fixed by construction here.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import PRECISION, bmm_small, bmv_small, det2, inv2, quad_small
from conan_slam.filters.common import CompactObs
from conan_slam.filters.ekf.state import EKFState
from conan_slam.models import sensor


class AssociationResult(NamedTuple):
    known_mask: jax.Array  # (NZ,) bool: measurement matched to an active slot
    slots: jax.Array       # (NZ,) int32 matched slot (valid where known_mask)
    new_mask: jax.Array    # (NZ,) bool: measurement should found a new feature


def associate_known(state: EKFState, obs: CompactObs) -> AssociationResult:
    """Ground-truth association via the id -> slot table.

    Reference EKF.cpp:169-182: a measurement whose landmark id is already in
    the table is a known feature; otherwise it is new.  Table/slot assignment
    for new features happens in ``augment`` (the reference does it inside
    dataAssociateTable, EKF.cpp:213-226 — same net effect, one owner here).
    """
    safe_ids = jnp.maximum(obs.ids, 0)
    slots = state.table[safe_ids]
    known = jnp.logical_and(obs.mask, slots >= 0)
    new = jnp.logical_and(obs.mask, slots < 0)
    return AssociationResult(known_mask=known, slots=jnp.maximum(slots, 0), new_mask=new)


def _innovation_stats(state: EKFState, r_cov, vmat=None, bmat=None):
    """Per-active-slot predicted measurement and innovation covariance.

    S_j = [Hv Hf] [[Pvv, Pvj], [Pjv, Pjj]] [Hv Hf]^T + R, assembled from the
    pose block, the pose-feature strip and the (K, 2, 2) diagonal feature
    blocks of P — no dense (2, D) rows are materialised (cf. the reference's
    full H P H^T per pair, EKF.cpp:140).

    With ``vmat``/``bmat`` the stats are computed against the *virtual*
    covariance P' = P + V B V^T (the pending frame correction from
    filters.ekf.fastframe.frame_factors) without materialising P': only the
    pose block, pose-feature strip and per-slot diagonal blocks of V B V^T
    are formed — O(D r) work instead of an O(D^2) rewrite of P.
    """
    k = state.capacity
    d = state.x.shape[0]
    zp, hv, hf = sensor.observe(state.pose, state.features)  # (K,2) (K,2,3) (K,2,2)
    pvv = state.p[:3, :3]
    pvm = state.p[:3, 3 : 3 + 2 * k].reshape(3, k, 2).transpose(1, 0, 2)  # (K, 3, 2)
    # Diagonal 2x2 feature blocks via a per-row two-column gather of the
    # diagonal band.  The naive reshape(k, 2, k, 2)[idx, :, idx, :] asks XLA
    # to materialise the (2K, 2K) -> (K, 2, K, 2) reshape before gathering —
    # 103 GB at K = 10k (observed compile-time HBM overflow); this form reads
    # exactly the 4K gathered elements.
    ridx = jnp.arange(d)
    base = jnp.where(ridx >= 3, 3 + 2 * ((ridx - 3) // 2), 0)
    cols = jnp.clip(base[:, None] + jnp.arange(2)[None, :], 0, d - 1)
    band = jnp.take_along_axis(state.p, cols, axis=1)               # (D, 2)
    pjj = band[3 : 3 + 2 * k].reshape(k, 2, 2)                      # (K, 2, 2)

    if vmat is not None:
        v3 = vmat[:3, :]                                            # (3, r)
        vm = vmat[3 : 3 + 2 * k, :].reshape(k, 2, -1)               # (K, 2, r)
        v3b = jnp.matmul(v3, bmat, precision=PRECISION)             # (3, r)
        pvv = pvv + jnp.matmul(v3b, v3.T, precision=PRECISION)
        # Pose-feature strips: (3, r) @ (r, 2) per slot.
        pvm = pvm + jnp.einsum(
            "ir,kjr->kij", v3b, vm, precision=PRECISION
        )
        # Diagonal feature blocks: Vm_k B Vm_k^T (tiny; broadcast algebra).
        vmb = jnp.einsum("kir,rs->kis", vm, bmat, precision=PRECISION)
        pjj = pjj + jnp.einsum("kir,kjr->kij", vmb, vm, precision=PRECISION)

    # Tiny-block algebra via broadcast ops (core.linalg.bmm_small), which
    # XLA fuses with the surrounding elementwise work.
    pvv_b = jnp.broadcast_to(pvv, hv.shape[:-2] + (3, 3))
    cross = bmm_small(bmm_small(hv, pvm), jnp.swapaxes(hf, -1, -2))  # Hv Pvj Hf^T
    s = (
        quad_small(hv, pvv_b)
        + cross
        + cross.transpose(0, 2, 1)
        + quad_small(hf, pjj)
        + r_cov
    )
    return zp, s


def associate_gated(
    state: EKFState, obs: CompactObs, r_cov, gate_reject, gate_augment,
    vmat=None, bmat=None,
) -> AssociationResult:
    """Gated nearest-neighbour association (reference EKF.cpp:263-296).

    For each measurement i and active slot j:
        nis_ij = v^T S_j^-1 v,   nd_ij = nis_ij + log |S_j|
    Accept the nd-argmin among slots passing ``nis < gate_reject``
    (EKF.cpp:275-279); measurements whose best NIS exceeds ``gate_augment``
    found new features (EKF.cpp:292-295).

    ``vmat``/``bmat`` gate against the virtual covariance P + V B V^T
    (see ``_innovation_stats``) so the fastframe fused path can associate
    without materialising the frame's predict+heading covariance effect.

    The (NZ, K) scoring is closed-form 2x2 algebra (``inv2``, ``det2``) that
    XLA fuses into a few elementwise and reduction kernels.
    """
    zp, s = _innovation_stats(state, r_cov, vmat, bmat)       # (K,2), (K,2,2)
    sinv = inv2(s)
    logdet = jnp.log(jnp.maximum(det2(s), 1e-30))

    v = obs.z[:, None, :] - zp[None, :, :]                    # (NZ, K, 2)
    v = v.at[..., 1].set(wrap_angle(v[..., 1]))
    siv = bmv_small(sinv[None, :, :, :], v)                   # (NZ, K, 2)
    nis = jnp.sum(v * siv, axis=-1)
    nd = nis + logdet[None, :]

    active = state.active_mask[None, :]                       # (1, K)
    inf = jnp.inf
    nis_act = jnp.where(active, nis, inf)
    gated = nis_act < gate_reject
    nd_gated = jnp.where(gated, nd, inf)

    jbest = jnp.argmin(nd_gated, axis=1).astype(jnp.int32)    # (NZ,)
    found = jnp.any(gated, axis=1)

    known = jnp.logical_and(obs.mask, found)
    min_nis = jnp.min(nis_act, axis=1)                        # inf when map empty
    new = jnp.logical_and(
        obs.mask, jnp.logical_and(jnp.logical_not(found), min_nis > gate_augment)
    )
    return AssociationResult(known_mask=known, slots=jbest, new_mask=new)
