"""Shared filter-side observation containers.

The reference compacts visible landmarks into ragged 2 x nz matrices
(``getVisibleLandmarks``, slam.h:608-683) — dynamic shapes that XLA cannot
compile.  Here measurements are compacted **on device** into a fixed-size
buffer of ``max_observations`` slots with a validity mask; the buffer size is
a static config choice (the sensor's finite range bounds simultaneous returns)
so every downstream kernel keeps a static shape.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.sim.sensor_sim import Observation


class CompactObs(NamedTuple):
    z: jax.Array     # (NZ, 2) (range, bearing) measurement buffer
    ids: jax.Array   # (NZ,) int32 landmark id of each slot (undefined if masked)
    mask: jax.Array  # (NZ,) bool slot validity


def compact(obs: Observation, size: int) -> CompactObs:
    """Pack visible returns into ``size`` slots, ascending landmark id.

    Ascending-id order matches the reference's visible-landmark iteration
    order (slam.h:637-657), which fixes the slot-assignment order of newly
    discovered features.  Overflow beyond ``size`` is dropped.
    """
    (idx,) = jnp.nonzero(obs.visible, size=size, fill_value=-1)
    mask = idx >= 0
    safe = jnp.maximum(idx, 0)
    return CompactObs(
        z=jnp.where(mask[:, None], obs.z[safe], 0.0),
        ids=jnp.where(mask, idx, -1).astype(jnp.int32),
        mask=mask,
    )
