"""Per-particle map maintenance: feature EKF updates and new features.

Reference: ``PF::featureUpdate`` (PF.cpp:222-277) — each observed feature's
2x2 EKF updates independently under the perfect-pose assumption — and
``PF::addOneNewFeature`` (PF.cpp:9-60).  Both are doubly batched here:
``vmap`` over particles x vectorised over the measurement buffer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import bmm_small, bmv_small, inv2, quad_small, sym
from conan_slam.filters.common import CompactObs
from conan_slam.filters.pf.state import ParticleEnsemble
from conan_slam.models import sensor


def feature_update(
    ens: ParticleEnsemble, obs: CompactObs, slots, mask, r_cov
) -> ParticleEnsemble:
    """2x2 Kalman update of each observed feature (reference PF.cpp:250-260).

    The reference routes these through the generic ``choleskyUpdate``; at 2x2
    a closed-form gain K = P H^T S^-1 is cheaper and exact.
    """
    from conan_slam.filters.pf.state import (
        gather_slots,
        scatter_slots,
        slot_selector,
    )

    safe_slots = jnp.clip(slots, 0, ens.capacity - 1)
    # Slot gather/scatter as one-hot contractions in place of (N, NZ)
    # latency-bound gather rows (slots are shared across particles, see
    # slot_selector).
    sel = slot_selector(safe_slots, ens.capacity)
    xf_s, pf_s = gather_slots(ens.xf, ens.pf, sel)      # (N,NZ,2) (N,NZ,2,2)

    zp, _, hf = jax.vmap(lambda pose, xfs: sensor.observe(pose, xfs))(
        ens.pose, xf_s
    )
    v = obs.z[None, :, :] - zp
    v = v.at[..., 1].set(wrap_angle(v[..., 1]))
    s = sym(quad_small(hf, pf_s, r_cov))
    hft = jnp.swapaxes(hf, -1, -2)
    k = bmm_small(bmm_small(pf_s, hft), inv2(s))        # P H^T S^-1
    xf_new = xf_s + bmv_small(k, v)
    kh = bmm_small(k, hf)
    pf_new = sym(pf_s - bmm_small(kh, pf_s))

    xf, pf = scatter_slots(ens.xf, ens.pf, sel, mask, xf_new, pf_new)
    return ens._replace(xf=xf, pf=pf)


def add_new_features(
    ens: ParticleEnsemble, obs: CompactObs, new_mask, r_cov
) -> ParticleEnsemble:
    """Initialise new features in every particle's map and assign shared slots.

    Reference PF.cpp:9-60 per particle; slot bookkeeping follows the EKF's
    table convention (the reference's PF table update iterates the wrong index
    vector and seeds slots from a particle count, PF.cpp:204-213 +
    main.cpp:299-300 — SURVEY.md defect 6; here slots are allocated from the
    shared active count exactly like the EKF path).
    """
    k_cap = ens.capacity
    rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    slots = ens.n_active + rank
    ok = jnp.logical_and(new_mask, slots < k_cap)
    safe_slots = jnp.where(ok, slots, k_cap)   # k_cap => dropped by scatter

    def one_particle(pose, xf, pf):
        xf_new, _, gz = sensor.init_feature(pose, obs.z)     # (NZ,2) (NZ,2,2)
        pf_new = quad_small(gz, jnp.broadcast_to(r_cov, gz.shape[:-2] + (2, 2)))
        xf = xf.at[safe_slots].set(xf_new, mode="drop")
        pf = pf.at[safe_slots].set(pf_new, mode="drop")
        return xf, pf

    xf, pf = jax.vmap(one_particle)(ens.pose, ens.xf, ens.pf)
    num_ids = ens.table.shape[0]
    table = ens.table.at[jnp.where(ok, obs.ids, num_ids)].set(
        slots.astype(jnp.int32), mode="drop"
    )
    return ens._replace(
        xf=xf,
        pf=pf,
        n_active=ens.n_active + jnp.sum(ok.astype(jnp.int32)),
        table=table,
    )
