"""Rao-Blackwellized particle ensemble, structure-of-arrays.

The reference keeps ``std::vector<Particle_t>`` with per-particle ragged maps
(``Particle_t``: slam.h:120-127) and loops over particles on the host
(test/main.cpp:279-328).  Batched redesign: one pytree of stacked arrays
``(N, ...)`` so every per-particle operation is a ``vmap`` over batched 2x2/3x3
block algebra, and resampling is a gather.

Map bookkeeping: with known association all particles share the same slot
layout (the id -> slot table is a function of the observation sequence, not of
a particle), so the table and active count live once in the ensemble, while
feature means/covariances are per particle.  Weights are kept in log space
(fixes the reference's likelihood underflow/defective log branch,
SURVEY.md defect 7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle


class ParticleEnsemble(NamedTuple):
    log_w: jax.Array     # (N,) log importance weights (unnormalised)
    pose: jax.Array      # (N, 3) per-particle vehicle pose
    pose_cov: jax.Array  # (N, 3, 3) per-particle pose covariance (proposal prior)
    xf: jax.Array        # (N, K, 2) per-particle feature means
    pf: jax.Array        # (N, K, 2, 2) per-particle feature covariances
    n_active: jax.Array  # () int32 shared active-slot count
    table: jax.Array     # (num_ids,) int32 shared id -> slot, -1 unknown

    @property
    def num_particles(self) -> int:
        return self.pose.shape[0]

    @property
    def capacity(self) -> int:
        return self.xf.shape[1]


def init_ensemble(
    num_particles: int, capacity: int, num_landmark_ids: int, dtype=jnp.float32
) -> ParticleEnsemble:
    """w = 1/N, zero pose/covariance, empty maps (reference PF.cpp:319-341)."""
    n, k = num_particles, capacity
    return ParticleEnsemble(
        log_w=jnp.full((n,), -jnp.log(float(n)), dtype=dtype),
        pose=jnp.zeros((n, 3), dtype=dtype),
        pose_cov=jnp.zeros((n, 3, 3), dtype=dtype),
        xf=jnp.zeros((n, k, 2), dtype=dtype),
        pf=jnp.zeros((n, k, 2, 2), dtype=dtype),
        n_active=jnp.int32(0),
        table=jnp.full((num_landmark_ids,), -1, dtype=jnp.int32),
    )


def normalized_weights(ens: ParticleEnsemble) -> jax.Array:
    """(N,) weights normalised to sum 1 (log-sum-exp stable)."""
    lw = ens.log_w - jnp.max(ens.log_w)
    w = jnp.exp(lw)
    return w / jnp.sum(w)


def best_pose(ens: ParticleEnsemble) -> jax.Array:
    """Pose of the max-weight particle.

    The reference's ``extractStatesFromParticles`` picks the *min*-weight
    particle (slam.h:505-508, SURVEY.md defect 3); the intent — and this
    implementation — is max weight.
    """
    return ens.pose[jnp.argmax(ens.log_w)]


def mean_pose(ens: ParticleEnsemble) -> jax.Array:
    """Weight-averaged pose with circular mean for the heading."""
    w = normalized_weights(ens)
    xy = jnp.sum(w[:, None] * ens.pose[:, :2], axis=0)
    phi = jnp.arctan2(
        jnp.sum(w * jnp.sin(ens.pose[:, 2])), jnp.sum(w * jnp.cos(ens.pose[:, 2]))
    )
    return jnp.concatenate([xy, wrap_angle(phi)[None]])


def slot_selector(safe_slots, capacity: int):
    """One-hot ``(K, NZ)`` float32 selector for the shared slot buffer.

    The observation buffer's slot indices are IDENTICAL across particles
    (association is against the shared table), so per-particle map
    gathers/scatters ``xf[:, slots]`` — (N x NZ) latency-bound gather rows
    — become tiny exact fp32 contractions against this selector instead
    (products are x*1 / x*0, so HIGHEST-precision selection is bit-exact).
    """
    return (
        jnp.arange(capacity)[:, None] == safe_slots[None, :]
    ).astype(jnp.float32)


def gather_slots(xf, pf, sel):
    """``(N,K,2), (N,K,2,2) -> (N,NZ,2), (N,NZ,2,2)`` via the one-hot
    selector (exact; see ``slot_selector``)."""
    from conan_slam.core.linalg import PRECISION

    xf_s = jnp.einsum("nkc,ks->nsc", xf, sel, precision=PRECISION)
    pf_s = jnp.einsum("nkab,ks->nsab", pf, sel, precision=PRECISION)
    return xf_s, pf_s


def scatter_slots(xf, pf, sel, mask, xf_new, pf_new):
    """Write back per-slot updates with exact set semantics: slot k keeps
    its old value unless a masked-true measurement updated it (one-hot
    select/blend — no latency-bound scatter, no float re-accumulation).

    Precondition: masked-true slots must be unique (one measurement per map
    slot — guaranteed by id-based ``associate_known``).  ``touched`` is
    clamped so a duplicated slot degrades to summed updates over a single
    old-value removal rather than corrupting the blend weights; callers that
    could produce duplicates must dedupe first (the old per-particle
    ``.at[slots].set`` was last-write-wins)."""
    from conan_slam.core.linalg import PRECISION

    touched = jnp.minimum(sel @ mask.astype(jnp.float32), 1.0)  # (K,)
    xfm = jnp.where(mask[None, :, None], xf_new, 0.0)
    pfm = jnp.where(mask[None, :, None, None], pf_new, 0.0)
    xf_out = xf * (1.0 - touched)[None, :, None] + jnp.einsum(
        "nsc,ks->nkc", xfm, sel, precision=PRECISION
    )
    pf_out = pf * (1.0 - touched)[None, :, None, None] + jnp.einsum(
        "nsab,ks->nkab", pfm, sel, precision=PRECISION
    )
    return xf_out, pf_out
