"""Sensor simulation: visibility, observation generation, noise injection.

Reference: ``getVisibleLandmarks`` (slam.h:608-683), ``getObservations``
(slam.h:575-582), ``addControlNoise`` (slam.h:149-159) and
``addObservationNoise`` (slam.h:168-178).

Static-shape redesign: the reference *compacts* visible landmarks into a ragged
2 x nz matrix, which would make every downstream shape dynamic.  Here the
sensor always returns measurements to **all** landmarks plus a boolean
visibility mask; downstream consumers (association, update, augment) are
mask-aware, so every shape in the program is static (SURVEY.md section 7.1).

RNG: the reference's noise generators are defective (clock re-seeded per call,
SURVEY.md defects 1-2); we use explicitly threaded ``jax.random`` keys — the
distributional contract (independent N(0, sigma^2) noise) is what's matched.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import range_bearing


class Observation(NamedTuple):
    z: jax.Array       # (num_landmarks, 2) (range, bearing) for every landmark
    visible: jax.Array  # (num_landmarks,) bool semicircular-FoV visibility


def visible_mask(pose, landmarks, max_range):
    """Semicircular field-of-view test (reference slam.h:644-648):
    bounding box AND heading half-plane AND range circle."""
    d = landmarks - pose[:2]
    dx, dy = d[..., 0], d[..., 1]
    in_box = jnp.logical_and(jnp.abs(dx) < max_range, jnp.abs(dy) < max_range)
    ahead = dx * jnp.cos(pose[2]) + dy * jnp.sin(pose[2]) > 0.0
    in_circle = dx * dx + dy * dy < max_range**2
    return jnp.logical_and(jnp.logical_and(in_box, ahead), in_circle)


def get_observations(pose_true, landmarks, max_range) -> Observation:
    """Exact range-bearing returns to all landmarks + visibility mask.

    Reference ``getObservations`` (slam.h:575-582), un-compacted.
    """
    rng, brg = range_bearing(pose_true, landmarks)
    return Observation(
        z=jnp.stack([rng, brg], axis=-1),
        visible=visible_mask(pose_true, landmarks, max_range),
    )


def add_observation_noise(key, obs: Observation, sigma_r, sigma_b, enabled: bool):
    """Additive N(0, R) noise on every return (reference slam.h:168-178)."""
    if not enabled:
        return obs
    noise = jax.random.normal(key, obs.z.shape, dtype=obs.z.dtype)
    scale = jnp.asarray([sigma_r, sigma_b], dtype=obs.z.dtype)
    return obs._replace(z=obs.z + noise * scale)


def add_control_noise(key, v, swa, sigma_v, sigma_swa, enabled: bool):
    """Noisy odometry (v, swa) (reference slam.h:149-159)."""
    if not enabled:
        return v, swa
    nv, ns = jax.random.normal(key, (2,), dtype=jnp.float32)
    return v + nv * sigma_v, swa + ns * sigma_swa
