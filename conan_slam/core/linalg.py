"""Small dense linear-algebra utilities shared by both estimators.

Replacements for the reference's Eigen helpers:
``makeSymmetric`` (slam.h:776-779), ``choleskyDecomposition`` with its
eigendecomposition fallback and zero-on-NaN guard (slam.h:413-436), and the
closed-form 2x2 / 3x3 inverses that the PF proposal needs in bulk
(PF.cpp:518-527).  Everything is jit-safe, batched, and guards numerical
failure with masked ``where`` fallbacks instead of try/catch
(the reference's degrade-don't-crash behaviour, slam.h:241-265).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Matmul precision for covariance algebra.  The filters are float32, and on
# the GPU a float32 product left at DEFAULT precision runs in TF32 on the
# tensor cores (a 10-bit mantissa, about three decimal digits).  Covariance
# updates lose positive definiteness at that precision, and gated mapping
# from scratch needs the full fp32 product (PARITY.md, "Gated-path
# precision"), so every product in the filters names this precision rather
# than relying on a caller's ``jax.default_matmul_precision`` context.
PRECISION = jax.lax.Precision.HIGHEST


def mm(a, b):
    """``a @ b`` at ``PRECISION``."""
    return jnp.matmul(a, b, precision=PRECISION)


def sym(a):
    """(A + A^T)/2 over the last two axes.  Reference ``makeSymmetric``."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def safe_cholesky(s, jitter: float = 0.0):
    """Lower Cholesky factor of a symmetric PSD matrix with a finite guard.

    The reference falls back to an eigendecomposition square root for
    semi-definite inputs and zeroes the factor on NaN (slam.h:421-434).
    Under jit a data-dependent fallback would force both paths to compile
    and the eigensolver is slow; instead we add an optional diagonal jitter
    and zero the result where non-finite, preserving the reference's
    "degrade, don't crash" contract.
    """
    n = s.shape[-1]
    if jitter:
        s = s + jitter * jnp.eye(n, dtype=s.dtype)
    chol = jnp.linalg.cholesky(sym(s))
    finite = jnp.all(jnp.isfinite(chol), axis=(-2, -1), keepdims=True)
    return jnp.where(finite, chol, jnp.zeros_like(chol))


def chol2(m):
    """Closed-form lower Cholesky of a (2, 2) SPD matrix (scalar arithmetic
    — no LAPACK custom call; matters inside per-frame scan bodies, where
    XLA does not hoist loop-invariant factorizations out of while loops)."""
    l00 = jnp.sqrt(m[0, 0])
    l10 = m[1, 0] / l00
    l11 = jnp.sqrt(jnp.maximum(m[1, 1] - l10 * l10, 0.0))
    z = jnp.zeros_like(l00)
    return jnp.stack([
        jnp.stack([l00, z]), jnp.stack([l10, l11]),
    ])


def inv2(m):
    """Closed-form inverse of (..., 2, 2) matrices (elementwise, no LU)."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    idet = jnp.where(det != 0, 1.0 / det, 0.0)
    return jnp.stack(
        [
            jnp.stack([d * idet, -b * idet], axis=-1),
            jnp.stack([-c * idet, a * idet], axis=-1),
        ],
        axis=-2,
    )


def det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv3(m):
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    idet = jnp.where(det != 0, 1.0 / det, 0.0)
    adj = jnp.stack(
        [
            jnp.stack([ca, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([cb, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([cc, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * idet[..., None, None]


def bmm_small(a, b):
    """Batched matmul for TINY trailing dims via broadcast-multiply-sum.

    ``jnp.einsum``/``@`` on (N, 3, 3)-style operands lower to batched
    dot_general calls sized for large matrices; the broadcast form is plain
    elementwise work that XLA fuses with its neighbours.
    a: (..., m, k), b: (..., k, n) -> (..., m, n).
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def bmv_small(a, v):
    """Batched matvec for tiny dims: (..., m, k) x (..., k) -> (..., m)."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def quad_small(h, p, r=None):
    """H P H^T + R for tiny blocks: (..., a, k), (..., k, k) -> (..., a, a)."""
    hp = bmm_small(h, p)
    out = jnp.sum(hp[..., :, None, :] * h[..., None, :, :], axis=-1)
    return out if r is None else out + r


def det3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def chol3(m, jitter: float = 0.0):
    """Closed-form lower Cholesky of (..., 3, 3) SPD matrices.

    Pure elementwise arithmetic — a generic batched ``jnp.linalg.cholesky``
    / triangular solve runs tiny problems through a library call per batch;
    these explicit formulas vectorise over arbitrary batch dims.
    Non-PSD inputs produce zeros (the reference's guard, slam.h:431-434).
    """
    eps = 1e-30
    a = m[..., 0, 0] + jitter
    l11 = jnp.sqrt(jnp.maximum(a, eps))
    l21 = m[..., 1, 0] / l11
    l31 = m[..., 2, 0] / l11
    t22 = m[..., 1, 1] + jitter - l21 * l21
    l22 = jnp.sqrt(jnp.maximum(t22, eps))
    l32 = (m[..., 2, 1] - l31 * l21) / l22
    t33 = m[..., 2, 2] + jitter - l31 * l31 - l32 * l32
    l33 = jnp.sqrt(jnp.maximum(t33, eps))
    zero = jnp.zeros_like(a)
    chol = jnp.stack(
        [
            jnp.stack([l11, zero, zero], axis=-1),
            jnp.stack([l21, l22, zero], axis=-1),
            jnp.stack([l31, l32, l33], axis=-1),
        ],
        axis=-2,
    )
    ok = jnp.logical_and(a > 0, jnp.logical_and(t22 > 0, t33 > 0))
    return jnp.where(ok[..., None, None], chol, jnp.zeros_like(chol))


def mvn_logpdf2(v, s, jitter: float = 0.0):
    """Closed-form log N(v; 0, S) for (..., 2) innovations, (..., 2, 2) S."""
    if jitter:
        s = s + jitter * jnp.eye(2, dtype=s.dtype)
    det = jnp.maximum(det2(s), 1e-30)
    maha = (
        s[..., 1, 1] * v[..., 0] ** 2
        - (s[..., 0, 1] + s[..., 1, 0]) * v[..., 0] * v[..., 1]
        + s[..., 0, 0] * v[..., 1] ** 2
    ) / det
    return -0.5 * (maha + jnp.log(det) + 2.0 * jnp.log(2.0 * jnp.pi))


def mvn_logpdf3(v, s, jitter: float = 0.0):
    """Closed-form log N(v; 0, S) for (..., 3) innovations, (..., 3, 3) S."""
    if jitter:
        s = s + jitter * jnp.eye(3, dtype=s.dtype)
    det = jnp.maximum(det3(s), 1e-30)
    si = inv3(s)
    maha = jnp.sum(v * bmv_small(si, v), axis=-1)
    return -0.5 * (maha + jnp.log(det) + 3.0 * jnp.log(2.0 * jnp.pi))


def solve_psd(s, b, jitter: float = 0.0):
    """Solve S x = b for symmetric positive-definite S via Cholesky."""
    chol = safe_cholesky(s, jitter)
    return jax.scipy.linalg.cho_solve((chol, True), b)


def sample_mvn(key, mean, cov, num_samples: int | None = None, jitter: float = 0.0):
    """Draw sample(s) from N(mean, cov) via the Cholesky factor.

    Replaces the reference's ``multivariateNormalGaussianDistribution``
    (slam.h:753-764), which reseeds its RNG with the constant 1 on every call
    (SURVEY.md defect 2) — here the stream is an explicit jax.random key.
    Returns (d,) when ``num_samples`` is None, else (num_samples, d).
    """
    d = mean.shape[-1]
    chol = safe_cholesky(cov, jitter)
    shape = (d,) if num_samples is None else (num_samples, d)
    eps = jax.random.normal(key, shape, dtype=mean.dtype)
    return mean + mm(eps, chol.T)


def mvn_logpdf(v, s, jitter: float = 0.0):
    """Log-density of N(0, S) at innovation(s) ``v`` (..., d).

    Correct log-space version of the reference's ``gaussEvaluate``
    (PF.cpp:279-317) whose log branch mistakenly sums the Cholesky diagonal
    instead of its log (SURVEY.md defect 7); the likelihood branch
    (PF.cpp:306-307) is the exp of this value.
    """
    d = v.shape[-1]
    chol = safe_cholesky(s, jitter)
    # Normalised innovation: solve L y = v.
    y = jax.scipy.linalg.solve_triangular(chol, v[..., None], lower=True)[..., 0]
    maha = jnp.sum(y * y, axis=-1)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.maximum(jnp.diagonal(chol, axis1=-2, axis2=-1), 1e-30)), axis=-1
    )
    return -0.5 * (maha + logdet + d * jnp.log(2.0 * jnp.pi))
