"""The covariance pass: one symmetric low-rank correction of P per frame.

The fastframe compounding (filters.ekf.fastframe) plus the Cholesky-form
measurement update reduce a whole observation frame to

    P <- P + V B V^T - W1 W1^T

one symmetric rank-(r + 2m) correction.  With the factors given as row
strips Vt (r, D) that is ``P + Vt^T (B Vt)``: one small product and one
(D, r) x (r, D) GEMM.  On the H100 XLA emits the GEMM (fp32 FFMA at HIGHEST)
and the addition of P as separate kernels, plus a D x D transpose at large
D, so P makes about three trips through device memory per frame instead of
one (traced in PERF.md); fusing them is ROADMAP S1.
"""

from __future__ import annotations

import jax.numpy as jnp

from conan_slam.core.linalg import PRECISION


def rank_update_t(p, vt, b):
    """P + Vt^T B Vt for row-major factor strips Vt (r, D)."""
    return p + jnp.matmul(
        vt.T, jnp.matmul(b, vt, precision=PRECISION), precision=PRECISION
    )
