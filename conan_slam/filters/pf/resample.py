"""On-device stratified resampling.

Reference: ``PF::resampleParticles`` / ``stratifiedResample`` /
``stratifiedRandom`` (PF.cpp:473-500, 546-596) — a host loop with two RNG
defects (N(0,1) stratum jitter, off-by-one index consumption; SURVEY.md
defects 8 and 13).  Device form: normalised cumulative weights +
``searchsorted`` against stratified uniforms + a whole-ensemble gather,
gated by the effective-sample-size test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.filters.pf.state import ParticleEnsemble, normalized_weights


def effective_count(weights) -> jax.Array:
    """Neff = 1 / sum(w^2) for normalised weights (reference PF.cpp:550-554)."""
    return 1.0 / jnp.maximum(jnp.sum(weights * weights), 1e-30)


def stratified_indices(key, weights, n: int) -> jax.Array:
    """Stratified resampling: one uniform draw per stratum ((i + u_i)/N),
    mapped through the inverse CDF."""
    u = (jnp.arange(n, dtype=weights.dtype) + jax.random.uniform(key, (n,), dtype=weights.dtype)) / n
    cum = jnp.cumsum(weights)
    return jnp.clip(jnp.searchsorted(cum, u), 0, n - 1)


def systematic_indices(key, weights, n: int) -> jax.Array:
    """Systematic (low-variance) resampling: ONE uniform shared by all
    strata ((i + u)/N).  Lower resampling variance than stratified; no
    reference analogue (robustness extension for small ensembles)."""
    u = (jnp.arange(n, dtype=weights.dtype)
         + jax.random.uniform(key, (), dtype=weights.dtype)) / n
    cum = jnp.cumsum(weights)
    return jnp.clip(jnp.searchsorted(cum, u), 0, n - 1)


def resample(
    ens: ParticleEnsemble, key, num_effective: float, enabled: bool,
    kind: str = "stratified", roughening: float = 0.0,
) -> ParticleEnsemble:
    """Resample when Neff drops below the threshold (reference PF.cpp:489-499).

    The gather touches every per-particle array (pose, covariance, whole
    maps); with a sharded ensemble this is the one cross-particle collective
    of the filter.

    ``kind``: "stratified" (reference semantics, defect-fixed) or
    "systematic" (low-variance).  ``roughening`` > 0 adds post-resample pose
    jitter with std = roughening * ensemble-spread * N^(-1/3) per component
    (Gordon-style regularisation against sample impoverishment in small
    ensembles; heading jitter wrapped).
    """
    if not enabled:
        return ens

    n = ens.num_particles
    k_idx, k_rough = jax.random.split(key)
    w = normalized_weights(ens)
    neff = effective_count(w)
    pick = systematic_indices if kind == "systematic" else stratified_indices
    idx = pick(k_idx, w, n)

    def do(ens):
        # ONE consolidated fat-row gather instead of four thin-row gathers.
        # The per-particle payload rows of the separate leaves are 12 B
        # (pose) .. 480 B (pf); packing the payload into one (N, 12 + 6K)
        # f32 matrix makes it a single gather of contiguous ~(48 + 24K)-byte
        # rows (768 B at K=30) — same bytes, ~4x fewer gathers.  Indices
        # stay monotone (strata walk the CDF left to right);
        # indices_are_sorted is semantically true (kept as a hint).
        k = ens.xf.shape[1]
        packed = jnp.concatenate(
            [
                ens.pose,                                    # (N, 3)
                ens.pose_cov.reshape(n, 9),
                ens.xf.reshape(n, 2 * k),
                ens.pf.reshape(n, 4 * k),
            ],
            axis=1,
        )
        out = jnp.take(packed, idx, axis=0, indices_are_sorted=True)
        pose = out[:, :3]
        pose_cov = out[:, 3:12].reshape(n, 3, 3)
        xf = out[:, 12 : 12 + 2 * k].reshape(n, k, 2)
        pf = out[:, 12 + 2 * k :].reshape(n, k, 2, 2)
        if roughening > 0.0:
            from conan_slam.core.geometry import wrap_angle

            spread = jnp.max(ens.pose, axis=0) - jnp.min(ens.pose, axis=0)
            sig = roughening * spread * float(n) ** (-1.0 / 3.0)
            pose = pose + sig * jax.random.normal(k_rough, pose.shape, pose.dtype)
            pose = pose.at[:, 2].set(wrap_angle(pose[:, 2]))
        return ParticleEnsemble(
            log_w=jnp.full((n,), -jnp.log(float(n)), dtype=ens.log_w.dtype),
            pose=pose,
            pose_cov=pose_cov,
            xf=xf,
            pf=pf,
            n_active=ens.n_active,
            table=ens.table,
        )

    return jax.lax.cond(neff < num_effective, do, lambda e: e, ens)
