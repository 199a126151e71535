"""FastSLAM 2.0 optimal-proposal sampling and importance weighting.

Reference: ``PF::sampleProposal`` (PF.cpp:502-544) — per particle, an
iterated Gaussian fusion over the associated measurements,

    P <- (Hv^T S^-1 Hv + P^-1)^-1
    X <- X + P Hv^T S^-1 v          (Jacobians relinearised at the fused X)

then a pose sample XS ~ N(X, P) and the weight update
w *= likelihood(XS) * prior(X0 -> XS) / proposal(X -> XS)
(reference PF.cpp:534-543, with ``likelihood`` PF.cpp:343-359).

The fusion is order-dependent, so it stays a ``lax.scan`` over the
measurement buffer inside a ``vmap`` over particles (SURVEY.md section 7.3
item 2).  Weights are accumulated in log space (fixes defect 7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import (
    PRECISION,
    bmm_small,
    bmv_small,
    chol3,
    inv2,
    inv3,
    mm,
    mvn_logpdf2,
    mvn_logpdf3,
    quad_small,
    sym,
)
from conan_slam.filters.common import CompactObs
from conan_slam.filters.pf.state import ParticleEnsemble
from conan_slam.models import sensor

_COV_JITTER = 1e-8


def _delta(x1, x2):
    """Pose innovation with wrapped heading (reference PF.cpp:62-68)."""
    d = x1 - x2
    return d.at[2].set(wrap_angle(d[2]))


def _particle_proposal(pose, cov, xf, pf, z, slots, mask, r_cov, key):
    """Fuse, sample and weight one particle.  Returns (pose', log_w_delta)."""

    def fuse(carry, inp):
        x, p = carry
        z_i, s_i, m_i = inp
        zp, hv, hf = sensor.observe(x, xf[s_i])
        sf = sym(mm(mm(hf, pf[s_i]), hf.T) + r_cov)
        sfi = inv2(sf)
        v = jnp.stack([z_i[0] - zp[0], wrap_angle(z_i[1] - zp[1])])
        p_new = inv3(mm(mm(hv.T, sfi), hv) + inv3(p))
        p_new = sym(p_new)
        x_new = x + mm(p_new, mm(hv.T, mm(sfi, v)))
        x_new = jnp.where(m_i, x_new, x)
        p_new = jnp.where(m_i, p_new, p)
        return (x_new, p_new), None

    (x_fused, p_fused), _ = jax.lax.scan(fuse, (pose, cov), (z, slots, mask))

    # Sample from the proposal (reference PF.cpp:534 via
    # multivariateNormalGaussianDistribution, slam.h:753-764 — whose rng is
    # reseeded with a constant every call, defect 2; jax.random here).
    chol = chol3(p_fused, _COV_JITTER)
    xs = x_fused + mm(chol, jax.random.normal(key, (3,), dtype=pose.dtype))
    xs = xs.at[2].set(wrap_angle(xs[2]))

    # Likelihood of the measurements at the sampled pose, Jacobians
    # relinearised at XS (reference likelihood -> computeJacobians with
    # particle.X = XS, PF.cpp:343-359).
    zp_s, _, hf_s = sensor.observe(xs, xf[slots])          # (NZ,2), (NZ,2,2)
    sf_s = sym(
        jnp.einsum("nab,nbc,ndc->nad", hf_s, pf[slots], hf_s,
                   precision=PRECISION) + r_cov
    )
    v_s = z - zp_s
    v_s = v_s.at[:, 1].set(wrap_angle(v_s[:, 1]))
    ll = jnp.sum(jnp.where(mask, mvn_logpdf2(v_s, sf_s, _COV_JITTER), 0.0))

    log_prior = mvn_logpdf3(_delta(pose, xs), cov, _COV_JITTER)
    log_prop = mvn_logpdf3(_delta(x_fused, xs), p_fused, _COV_JITTER)
    return xs, ll + log_prior - log_prop


def _particle_proposal_batched(pose, cov, xf_s, pf_s, z, mask, r_cov, key):
    """One-shot information-form fusion: all Jacobians linearised at the
    predicted pose, fused jointly.

    Lambda = P^-1 + sum_i Hv_i^T S_i^-1 Hv_i;  X += Lambda^-1 sum Hv^T S^-1 v

    ~10 kernels per frame instead of NZ sequential fusion iterations.  This
    is a (slightly) different proposal distribution than the reference's
    iterated fusion — still an exact SMC algorithm, because the importance
    weight divides by the density of the proposal actually sampled from.
    ``xf_s``/``pf_s`` are the per-slot map blocks, pre-gathered at the
    ensemble level (one-hot selection — state.slot_selector).
    """
    zp, hv, hf = sensor.observe(pose, xf_s)                     # (NZ, ...)
    sf = sym(quad_small(hf, pf_s, r_cov))
    sfi = inv2(sf)
    v = z - zp
    v = v.at[:, 1].set(wrap_angle(v[:, 1]))
    m3 = mask[:, None, None].astype(pose.dtype)
    hvt = jnp.swapaxes(hv, -1, -2)                              # (NZ, 3, 2)
    hvt_sfi = bmm_small(hvt, sfi)                               # (NZ, 3, 2)
    lam = inv3(cov) + jnp.sum(m3 * bmm_small(hvt_sfi, hv), axis=0)
    p_fused = sym(inv3(lam))
    info_vec = jnp.sum(mask[:, None] * bmv_small(hvt_sfi, v), axis=0)
    x_fused = pose + bmv_small(p_fused, info_vec)

    chol = chol3(p_fused, _COV_JITTER)
    xs = x_fused + bmv_small(chol, jax.random.normal(key, (3,), dtype=pose.dtype))
    xs = xs.at[2].set(wrap_angle(xs[2]))

    # Likelihood at the sampled pose (as in the sequential form).  All
    # densities via closed-form 2x2/3x3 routines (no batched library linalg).
    zp_s, _, hf_s = sensor.observe(xs, xf_s)
    sf_s = sym(quad_small(hf_s, pf_s, r_cov))
    v_s = z - zp_s
    v_s = v_s.at[:, 1].set(wrap_angle(v_s[:, 1]))
    ll = jnp.sum(jnp.where(mask, mvn_logpdf2(v_s, sf_s, _COV_JITTER), 0.0))
    log_prior = mvn_logpdf3(_delta(pose, xs), cov, _COV_JITTER)
    log_prop = mvn_logpdf3(_delta(x_fused, xs), p_fused, _COV_JITTER)
    return xs, ll + log_prior - log_prop


def sample_proposal(
    ens: ParticleEnsemble, obs: CompactObs, slots, mask, r_cov, key,
    relinearize: bool = False,
) -> ParticleEnsemble:
    """Vmapped proposal step; pose covariance is zeroed after sampling
    (the sampled pose is treated as exact, reference PF.cpp:536-537).

    ``relinearize=True`` reproduces the reference's order-dependent iterated
    fusion (PF.cpp:513-531) via a per-particle scan; the default one-shot
    fusion is the batched variant (see _particle_proposal_batched).
    """
    n = ens.num_particles
    keys = jax.random.split(key, n)
    safe_slots = jnp.clip(slots, 0, ens.capacity - 1)
    if relinearize:
        xs, dlw = jax.vmap(
            _particle_proposal, in_axes=(0, 0, 0, 0, None, None, None, None, 0)
        )(ens.pose, ens.pose_cov, ens.xf, ens.pf, obs.z, safe_slots, mask,
          r_cov, keys)
    else:
        from conan_slam.filters.pf.state import gather_slots, slot_selector

        sel = slot_selector(safe_slots, ens.capacity)
        xf_s, pf_s = gather_slots(ens.xf, ens.pf, sel)
        xs, dlw = jax.vmap(
            _particle_proposal_batched,
            in_axes=(0, 0, 0, 0, None, None, None, 0),
        )(ens.pose, ens.pose_cov, xf_s, pf_s, obs.z, mask, r_cov, keys)
    return ens._replace(
        pose=xs,
        pose_cov=jnp.zeros_like(ens.pose_cov),
        log_w=ens.log_w + dlw,
    )
