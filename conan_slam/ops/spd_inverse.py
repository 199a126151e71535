"""Inverse of the innovation covariance S (symmetric positive definite).

The fused measurement update needs S^-1 for S = H P' H^T + R (2NZ x 2NZ,
128 x 128 at the benchmark shapes).  S mixes range^2 and bearing^2 scales,
so it is Jacobi pre-scaled (S -> D^-1/2 S D^-1/2, unit diagonal) before a
Cholesky factorisation and one triangular inverse; on the GPU XLA hands
both to cuSOLVER / cuBLAS.  A failed factorisation yields zeros rather than
NaN, preserving the reference's degrade-don't-crash contract
(slam.h:431-434).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.linalg import PRECISION, safe_cholesky, sym


def spd_inverse(s):
    """Jacobi-scaled Cholesky inverse of an SPD matrix; zeros on failure."""
    m = s.shape[0]
    s = sym(s)
    diag = jnp.diagonal(s)
    dsc = jax.lax.rsqrt(jnp.maximum(diag, 1e-30))
    shat = s * dsc[:, None] * dsc[None, :]

    chol = safe_cholesky(shat)
    eye = jnp.eye(m, dtype=s.dtype)
    linv = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    si_hat = jnp.matmul(linv.T, linv, precision=PRECISION)

    si = si_hat * dsc[:, None] * dsc[None, :]
    finite = jnp.all(jnp.isfinite(si))
    return jnp.where(finite, sym(si), jnp.zeros_like(si))
