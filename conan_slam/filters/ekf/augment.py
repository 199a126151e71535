"""State augmentation: founding new map features.

Reference: ``EKF::augment`` loops ``addOneNewFeature`` per new measurement
(EKF.cpp:9-91), resizing X and P each time.  Here augmentation is a single
batched *masked block write* into the pre-allocated state:

  for each new measurement i (slot s_i = n_active + rank_i):
    xf_i              = inverse sensor model               (EKF.cpp:47-48)
    P[s_i, s_i]       = Gv_i Pvv Gv_i^T + Gz_i R Gz_i^T   (EKF.cpp:74)
    P[s_i, pose]      = Gv_i Pvv                           (EKF.cpp:77)
    P[s_i, old map]   = Gv_i Pvm                           (EKF.cpp:83)
    P[s_i, s_j], j<i  = Gv_i Pvv Gv_j^T

The last line is what the reference's *sequential* augmentation produces for
features added in the same scan (feature j is already in the map when i is
added, so its cross block is Gv_i P_v,fj = Gv_i Pvv Gv_j^T); the batched form
writes all pairs at once and is exactly sequential-equivalent because
``addOneNewFeature`` never modifies the pose block it linearises around.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.linalg import PRECISION, quad_small
from conan_slam.filters.common import CompactObs
from conan_slam.filters.ekf.state import EKFState
from conan_slam.models import sensor


def augment(state: EKFState, obs: CompactObs, new_mask, r_cov) -> EKFState:
    """Found a new feature for every masked measurement; update id table.

    Measurements beyond remaining capacity are dropped (the map is full —
    a condition the reference cannot express; its state grows unboundedly).
    """
    nz = obs.z.shape[0]
    k = state.capacity
    d = state.x.shape[0]

    # Slot assignment in buffer order (ascending landmark id, matching the
    # reference's sequential discovery order, EKF.cpp:213-226).
    rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    slots = state.n_active + rank
    ok = jnp.logical_and(new_mask, slots < k)
    # Out-of-bounds row index => dropped by scatter mode="drop".
    row0 = jnp.where(ok, 3 + 2 * slots, d)

    xf, gv, gz = sensor.init_feature(state.pose, obs.z)   # (NZ,2) (NZ,2,3) (NZ,2,2)

    # --- mean: scatter feature positions ---
    x = state.x
    rows2 = jnp.stack([row0, row0 + 1], axis=1).reshape(-1)          # (2 NZ,)
    x = x.at[rows2].set(xf.reshape(-1), mode="drop")

    # --- covariance rows: Gv_i @ P[0:3, :] covers pose + existing map ---
    p = state.p
    strips = jnp.einsum("nab,bd->nad", gv, p[:3, :], precision=PRECISION)  # (NZ,2,D)
    p = p.at[rows2, :].set(strips.reshape(2 * nz, d), mode="drop")
    p = p.at[:, rows2].set(strips.reshape(2 * nz, d).T, mode="drop")

    # --- new-new cross blocks (incl. diagonal) ---
    pvv = state.p[:3, :3]
    cross = jnp.einsum(
        "iab,bc,jdc->iajd", gv, pvv, gv, precision=PRECISION
    )                                                                # (NZ,2,NZ,2)
    diag_extra = quad_small(gz, jnp.broadcast_to(r_cov, gz.shape[:-2] + (2, 2)))
    idx = jnp.arange(nz)
    cross = cross.at[idx, :, idx, :].add(diag_extra)
    p = p.at[rows2[:, None], rows2[None, :]].set(
        cross.reshape(2 * nz, 2 * nz), mode="drop"
    )

    # --- bookkeeping: active count and id table ---
    n_new = jnp.sum(ok.astype(jnp.int32))
    num_ids = state.table.shape[0]
    table = state.table.at[jnp.where(ok, obs.ids, num_ids)].set(
        slots.astype(jnp.int32), mode="drop"
    )
    return EKFState(x=x, p=p, n_active=state.n_active + n_new, table=table)
