"""FastSLAM 2.0: Rao-Blackwellized particle filter SLAM.

Device-resident equivalent of the reference ``PF`` engine (PF.h:5-321,
PF.cpp:1-596): vmapped particle ensemble, sequential-equivalent proposal
fusion, on-device resampling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.filters.common import CompactObs
from conan_slam.filters.pf.state import (
    ParticleEnsemble,
    best_pose,
    init_ensemble,
    mean_pose,
    normalized_weights,
)
from conan_slam.filters.pf.predict import observe_heading, predict
from conan_slam.filters.pf.proposal import sample_proposal
from conan_slam.filters.pf.resample import effective_count, resample, stratified_indices
from conan_slam.filters.pf.update import add_new_features, feature_update


def associate_known(ens: ParticleEnsemble, obs: CompactObs):
    """Shared-table association (reference PF::dataAssociateTable,
    PF.cpp:137-220, with its slot-assignment defects fixed — see update.py)."""
    safe_ids = jnp.maximum(obs.ids, 0)
    slots = ens.table[safe_ids]
    known = jnp.logical_and(obs.mask, slots >= 0)
    new = jnp.logical_and(obs.mask, slots < 0)
    return known, jnp.maximum(slots, 0), new


def observation_step(
    ens: ParticleEnsemble,
    obs: CompactObs,
    r_cov,
    key,
    *,
    num_effective: float,
    sample_proposal_on: bool,
    resample_on: bool,
    proposal_relinearize: bool = False,
    resample_kind: str = "stratified",
    roughening: float = 0.0,
    resample_fn=None,
) -> ParticleEnsemble:
    """Associate -> proposal+feature updates -> resample -> new features,
    mirroring the driver's PF observation branch (test/main.cpp:290-333).

    ``resample_fn(ens, key, num_effective, enabled, kind, roughening)``
    overrides the resampling implementation — the distributed layer passes
    the explicit ring-ppermute resample (parallel.dist_pf.sharded_resample)
    so the WHOLE observation step runs under particle sharding."""
    k_prop, k_res, k_samp = jax.random.split(key, 3)
    known, slots, new = associate_known(ens, obs)
    have_known = jnp.any(known)
    have_new = jnp.any(new)

    def known_branch(ens):
        if sample_proposal_on:
            e = sample_proposal(ens, obs, slots, known, r_cov, k_prop,
                                relinearize=proposal_relinearize)
        else:
            e = ens
        e = feature_update(e, obs, slots, known, r_cov)
        if resample_fn is not None:
            return resample_fn(e, k_res, num_effective, resample_on,
                               kind=resample_kind, roughening=roughening)
        return resample(e, k_res, num_effective, resample_on,
                        kind=resample_kind, roughening=roughening)

    ens = jax.lax.cond(have_known, known_branch, lambda e: e, ens)

    def new_branch(ens):
        # With no associated features this step, the pose is still sampled
        # from the prior before map insertion (reference main.cpp:319-325).
        def sample_pose(e):
            keys = jax.random.split(k_samp, e.num_particles)

            def one(pose, cov, kk):
                from conan_slam.core.linalg import bmv_small, chol3

                return pose + bmv_small(
                    chol3(cov, 1e-8), jax.random.normal(kk, (3,), dtype=pose.dtype)
                )

            pose = jax.vmap(one)(e.pose, e.pose_cov, keys)
            return e._replace(pose=pose, pose_cov=jnp.zeros_like(e.pose_cov))

        ens = jax.lax.cond(have_known, lambda e: e, sample_pose, ens)
        return add_new_features(ens, obs, new, r_cov)

    return jax.lax.cond(have_new, new_branch, lambda e: e, ens)


__all__ = [
    "ParticleEnsemble",
    "init_ensemble",
    "normalized_weights",
    "best_pose",
    "mean_pose",
    "predict",
    "observe_heading",
    "sample_proposal",
    "feature_update",
    "add_new_features",
    "resample",
    "effective_count",
    "stratified_indices",
    "associate_known",
    "observation_step",
]
