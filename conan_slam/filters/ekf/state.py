"""Static-capacity EKF-SLAM state.

The reference grows ``X``/``P`` dynamically as landmarks are found
(EKF.cpp:41, 69) — impossible under XLA's static-shape model.  Here the joint
state is pre-allocated at capacity ``K = max_landmarks`` slots (state dim
D = 3 + 2K) with an active-slot count and a landmark-id -> slot table
(the reference's ``mTABLE``, slam.h:105, kept 0-based with -1 = unknown).
Inactive slots hold zeros and are excluded from every kernel by masking.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class EKFState(NamedTuple):
    x: jax.Array         # (D,) joint mean: pose (x, y, phi) then map slots
    p: jax.Array         # (D, D) joint covariance
    n_active: jax.Array  # () int32 number of active map slots
    table: jax.Array     # (num_landmark_ids,) int32 id -> slot, -1 unknown

    # D is 3 + 2K for the requested capacity K, optionally rounded up to a
    # multiple (``init_state(pad_multiple=...)``; 256 by default, a choice
    # kept from an earlier tiled-kernel design and not yet re-measured on the
    # GPU — at the 1,024-landmark shape it grows P by (2304/2051)^2 ~ 1.26x).
    # Padding manifests
    # only as extra (never-activated unless discovered) map slots plus at
    # most one dead trailing row/column of zeros — every kernel is
    # mask/width-aware, so semantics are unchanged.

    @property
    def capacity(self) -> int:
        return (self.x.shape[0] - 3) // 2

    @property
    def pose(self) -> jax.Array:
        return self.x[:3]

    @property
    def features(self) -> jax.Array:
        """Map slot positions as (K, 2)."""
        k = self.capacity
        return self.x[3 : 3 + 2 * k].reshape(k, 2)

    @property
    def active_mask(self) -> jax.Array:
        """(K,) bool mask of active slots."""
        return jnp.arange(self.capacity) < self.n_active


def _padded_dim(capacity: int, pad_multiple: int) -> int:
    d = 3 + 2 * capacity
    if pad_multiple and d > pad_multiple:
        d = ((d + pad_multiple - 1) // pad_multiple) * pad_multiple
    return d


def init_state(
    capacity: int, num_landmark_ids: int, dtype=jnp.float32,
    pad_multiple: int = 256,
) -> EKFState:
    """Zero pose, zero covariance, empty map (reference test/main.cpp:106-108).

    ``pad_multiple`` rounds the state dimension up to a multiple for large
    maps (small worlds stay compact); 0 disables padding.
    """
    d = _padded_dim(capacity, pad_multiple)
    return EKFState(
        x=jnp.zeros((d,), dtype=dtype),
        p=jnp.zeros((d, d), dtype=dtype),
        n_active=jnp.int32(0),
        table=jnp.full((num_landmark_ids,), -1, dtype=jnp.int32),
    )


def init_state_with_map(
    landmarks, capacity: int | None = None, sigma0: float = 1.0,
    dtype=jnp.float32, pad_multiple: int = 256,
) -> EKFState:
    """Steady-state start: the first ``capacity`` landmarks pre-registered.

    Models a mapped facility (the valet/parking use case after a mapping run):
    feature means at the given positions with independent ``sigma0^2 I`` blocks.
    No reference analogue (the reference always starts empty); used by the
    full-map tracking benchmarks (BASELINE.json configs 2/5).
    """
    landmarks = jnp.asarray(landmarks, dtype)
    n_ids = landmarks.shape[0]
    k = capacity if capacity is not None else n_ids
    n_map = min(n_ids, k)
    state = init_state(k, n_ids, dtype, pad_multiple=pad_multiple)
    x = state.x.at[3 : 3 + 2 * n_map].set(landmarks[:n_map].reshape(-1))
    diag = (
        jnp.zeros((state.x.shape[0],), dtype)
        .at[3 : 3 + 2 * n_map]
        .set(sigma0**2)
    )
    p = state.p + jnp.diag(diag)
    table = state.table.at[:n_map].set(jnp.arange(n_map, dtype=jnp.int32))
    return EKFState(x=x, p=p, n_active=jnp.int32(n_map), table=table)
