"""Distributed particle filter: ensemble sharded over the ``particles`` axis.

The particle axis shards like a batch axis (DP analogue, SURVEY.md
section 2.2/5): predict, proposal and feature updates are embarrassingly
parallel and keep their single-device vmapped implementations — placement
via NamedSharding makes XLA partition them with zero communication.  The
only cross-particle exchanges are (a) the weight reduction for
normalisation/Neff and (b) the resampling gather (an all-to-all XLA emits
from the sharded ``take``), exactly the reference's lone synchronisation
point (PF.cpp:477-499).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from conan_slam.filters.pf.state import ParticleEnsemble
from conan_slam.parallel.mesh import PARTICLE_AXIS


def particle_sharding(mesh, axis: str = PARTICLE_AXIS):
    """Shardings for each ensemble leaf: particle-axis leaves split, shared
    map bookkeeping replicated."""
    split = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    return ParticleEnsemble(
        log_w=split,
        pose=split,
        pose_cov=split,
        xf=split,
        pf=split,
        n_active=repl,
        table=repl,
    )


def shard_ensemble(mesh, ens: ParticleEnsemble, axis: str = PARTICLE_AXIS) -> ParticleEnsemble:
    """Place an ensemble on the mesh (particle count must divide the axis)."""
    shardings = particle_sharding(mesh, axis)
    return jax.tree_util.tree_map(jax.device_put, ens, shardings)


def constrain(ens: ParticleEnsemble, mesh, axis: str = PARTICLE_AXIS) -> ParticleEnsemble:
    """In-jit sharding constraint keeping the ensemble on its layout."""
    shardings = particle_sharding(mesh, axis)
    return jax.tree_util.tree_map(jax.lax.with_sharding_constraint, ens, shardings)


def sharded_resample(
    mesh, ens: ParticleEnsemble, key, num_effective: float,
    kind: str = "stratified", axis: str = PARTICLE_AXIS,
) -> ParticleEnsemble:
    """Explicit shard_map resampling with a ring ``ppermute`` exchange.

    The implicit path (a sharded ``take`` left to the GSPMD partitioner) is
    correct but its communication schedule is whatever XLA emits; this is the
    hand-scheduled equivalent with an explicit, auditable wire cost:

      * weights: one (1,) psum for the total + Neff, one (n_shards,)
        all_gather of shard partial sums, one tiled all_gather of the (N,)
        global CDF — O(N) floats, independent of map size.
      * payload: a ring of ``n_shards`` ``ppermute`` steps rotating each
        shard's (chunk, ...) particle block once around the mesh; every shard
        copies the rows it needs as each block passes — O(N x payload) bytes
        total on the wire, the unavoidable cost of an arbitrary cross-shard
        permutation, but moved over neighbour links with bounded
        per-step memory (one visiting block) instead of an opaque all-to-all.

    Index semantics match filters.pf.resample exactly (same stratified /
    systematic uniforms from the same key, sliced per shard), so the result
    equals the single-device resample up to float32 cumsum reassociation.
    Resampling is applied iff the replicated Neff < ``num_effective``
    (selected by masking — collectives run unconditionally, which shard_map
    requires anyway).
    """
    n = ens.num_particles
    n_shards = mesh.shape[axis]
    chunk = n // n_shards
    assert chunk * n_shards == n, (n, n_shards)
    k_idx, _ = jax.random.split(key)

    def kernel(log_w_l, pose_l, pose_cov_l, xf_l, pf_l):
        i = jax.lax.axis_index(axis)
        # Replicated-safe weight normalisation (log-space, global max).
        m = jax.lax.pmax(jnp.max(log_w_l), axis)
        w_l = jnp.exp(log_w_l - m)
        tot = jax.lax.psum(jnp.sum(w_l), axis)
        w_l = w_l / jnp.maximum(tot, 1e-30)
        neff = 1.0 / jnp.maximum(jax.lax.psum(jnp.sum(w_l * w_l), axis), 1e-30)

        # Global CDF: shard-prefix offset + local cumsum, all-gathered (O(N)).
        sums = jax.lax.all_gather(jnp.sum(w_l), axis)             # (n_shards,)
        prefix = jnp.sum(jnp.where(jnp.arange(n_shards) < i, sums, 0.0))
        cum_l = prefix + jnp.cumsum(w_l)
        cum = jax.lax.all_gather(cum_l, axis, axis=0, tiled=True)  # (N,)

        # Stratified/systematic strata for THIS shard's output slots, drawn
        # from the same replicated key as the single-device path.
        base = i * chunk
        slot = base + jnp.arange(chunk)
        if kind == "systematic":
            u0 = jax.random.uniform(k_idx, (), dtype=w_l.dtype)
            u = (slot.astype(w_l.dtype) + u0) / n
        else:
            u_all = jax.random.uniform(k_idx, (n,), dtype=w_l.dtype)
            u_l = jax.lax.dynamic_slice_in_dim(u_all, base, chunk)
            u = (slot.astype(w_l.dtype) + u_l) / n
        idx_g = jnp.clip(jnp.searchsorted(cum, u), 0, n - 1)       # global ids

        perm = [(s, (s + 1) % n_shards) for s in range(n_shards)]

        def ring_gather(payload_l):
            tail = (1,) * (payload_l.ndim - 1)

            def body(t, carry):
                blk, out = carry
                owner = (i - t) % n_shards
                local = idx_g - owner * chunk
                hit = jnp.logical_and(local >= 0, local < chunk)
                take = blk[jnp.clip(local, 0, chunk - 1)]
                out = jnp.where(hit.reshape((-1,) + tail), take, out)
                blk = jax.lax.ppermute(blk, axis, perm)
                return blk, out

            # payload_l * 0 (not jnp.zeros): keeps the accumulator varying
            # over the particle axis so the fori_loop carry types match.
            out0 = payload_l * 0
            _, out = jax.lax.fori_loop(0, n_shards, body, (payload_l, out0))
            return out

        do = neff < num_effective

        def sel(new, old):
            return jnp.where(
                jnp.reshape(do, (1,) * old.ndim), new, old
            )

        pose_n = sel(ring_gather(pose_l), pose_l)
        pose_cov_n = sel(ring_gather(pose_cov_l), pose_cov_l)
        xf_n = sel(ring_gather(xf_l), xf_l)
        pf_n = sel(ring_gather(pf_l), pf_l)
        logw_n = jnp.where(
            do, jnp.full((chunk,), -jnp.log(float(n)), log_w_l.dtype), log_w_l
        )
        return logw_n, pose_n, pose_cov_n, xf_n, pf_n

    logw, pose, pose_cov, xf, pf = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
    )(ens.log_w, ens.pose, ens.pose_cov, ens.xf, ens.pf)
    return ens._replace(
        log_w=logw, pose=pose, pose_cov=pose_cov, xf=xf, pf=pf
    )


def _resample_with_roughening(
    mesh, ens: ParticleEnsemble, key, num_effective, enabled,
    kind: str = "stratified", roughening: float = 0.0,
    axis: str = PARTICLE_AXIS,
) -> ParticleEnsemble:
    """``filters.pf.resample``-signature adapter over ``sharded_resample``.

    Ring-ppermute resample plus (when configured) the Gordon-style
    post-resample pose roughening of the single-device path — the jitter is
    drawn from the same global key/shape, so results match the single-device
    resample exactly; the spread reduction and elementwise jitter partition
    over the particle axis under GSPMD.
    """
    if not enabled:
        return ens
    out = sharded_resample(mesh, ens, key, num_effective, kind, axis)
    if roughening > 0.0:
        from conan_slam.core.geometry import wrap_angle
        from conan_slam.filters.pf.state import normalized_weights
        from conan_slam.filters.pf.resample import effective_count

        _, k_rough = jax.random.split(key)
        did = effective_count(normalized_weights(ens)) < num_effective
        n = ens.num_particles
        spread = jnp.max(ens.pose, axis=0) - jnp.min(ens.pose, axis=0)
        sig = roughening * spread * float(n) ** (-1.0 / 3.0)
        pose = out.pose + sig * jax.random.normal(
            k_rough, out.pose.shape, out.pose.dtype
        )
        pose = pose.at[:, 2].set(wrap_angle(pose[:, 2]))
        out = out._replace(pose=jnp.where(did, pose, out.pose))
    return out


def sharded_observation_step(
    mesh, ens: ParticleEnsemble, obs, r_cov, key, *,
    num_effective: float,
    sample_proposal_on: bool,
    resample_on: bool,
    proposal_relinearize: bool = False,
    resample_kind: str = "stratified",
    roughening: float = 0.0,
    axis: str = PARTICLE_AXIS,
) -> ParticleEnsemble:
    """The FULL PF observation block under particle sharding.

    Runs the single-device ``filters.pf.observation_step`` — optimal-proposal
    sampling (reference PF.cpp:502-544), per-feature 2x2 map updates
    (PF.cpp:222-277), new-feature founding (PF.cpp:9-60) and the replicated
    table bookkeeping — with the ensemble constrained to the particles mesh
    axis, and the resampling swapped for the explicit ring-ppermute
    collective.  The vmapped per-particle blocks partition with zero
    communication (their only cross-particle data — obs, table, n_active —
    is replicated); the ``lax.cond`` gates dispatch on replicated
    predicates.  Equivalence with the single-device step is asserted in
    tests/test_parallel.py.
    """
    from conan_slam.filters import pf as pf_mod

    ens = constrain(ens, mesh, axis)
    out = pf_mod.observation_step(
        ens, obs, r_cov, key,
        num_effective=num_effective,
        sample_proposal_on=sample_proposal_on,
        resample_on=resample_on,
        proposal_relinearize=proposal_relinearize,
        resample_kind=resample_kind,
        roughening=roughening,
        resample_fn=functools.partial(
            _resample_with_roughening, mesh, axis=axis
        ),
    )
    return constrain(out, mesh, axis)
