"""EKF observation-side helpers: batched H assembly and heading observation.

Reference: ``EKF::observeModel`` (EKF.cpp:354-404) fills one sparse 2 x lenX
Jacobian per measurement inside the batch-update loop (EKF.cpp:108-121); here
all measurement rows are built in one batched pass — the sensor-model blocks
come from ``models.sensor.observe`` and are scattered into the joint operator
with a vmapped dynamic-slice write.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.filters.common import CompactObs
from conan_slam.filters.ekf.state import EKFState
from conan_slam.models import sensor
from conan_slam.ops.cholesky_update import joseph_update_scalar


def assemble_operator(pose, features, z, slots, mask, r_cov, d: int):
    """Stacked (masked) innovation, Jacobian and noise for a batch update.

    Args:
      pose: (3,) vehicle pose to linearise at.
      features: (K, 2) map slot positions.
      z: (NZ, 2) measurement buffer.
      slots: (NZ,) int32 map slot index for each measurement.
      mask: (NZ,) bool which measurements participate.
      d: total (possibly padded) state dimension of the target operator.
    Returns:
      v: (2 NZ,) innovation, zero on masked rows.
      h: (2 NZ, d) Jacobian, zero on masked rows.
      rr: (2 NZ, 2 NZ) block-diag noise, identity on masked rows
          (reference assembles the same stack at EKF.cpp:104-121).
    """
    nz = z.shape[0]
    cap = features.shape[0]
    safe_slots = jnp.clip(slots, 0, cap - 1)
    xf = features[safe_slots]                            # (NZ, 2)
    zp, hv, hf = sensor.observe(pose, xf)                # (NZ,2) (NZ,2,3) (NZ,2,2)

    v = z - zp
    v = jnp.stack([v[:, 0], wrap_angle(v[:, 1])], axis=-1)
    v = jnp.where(mask[:, None], v, 0.0).reshape(2 * nz)

    h_rows = jnp.zeros((nz, 2, d), dtype=z.dtype)
    h_rows = h_rows.at[:, :, :3].set(hv)

    def place(row, blk, slot):
        return jax.lax.dynamic_update_slice(row, blk, (0, 3 + 2 * slot))

    h_rows = jax.vmap(place)(h_rows, hf, safe_slots)
    h = jnp.where(mask[:, None, None], h_rows, 0.0).reshape(2 * nz, d)

    eye2 = jnp.eye(2, dtype=z.dtype)
    r_blocks = jnp.where(mask[:, None, None], r_cov, eye2)   # (NZ, 2, 2)
    return v, h, _block_diag2(r_blocks)


def build_batch_operator(state: EKFState, obs: CompactObs, slots, mask, r_cov):
    """EKFState wrapper over ``assemble_operator``."""
    return assemble_operator(
        state.pose, state.features, obs.z, slots, mask, r_cov, state.x.shape[0]
    )


def _block_diag2(blocks):
    """(NZ, 2, 2) -> (2 NZ, 2 NZ) block diagonal."""
    nz = blocks.shape[0]
    out = jnp.zeros((nz, 2, nz, 2), dtype=blocks.dtype)
    idx = jnp.arange(nz)
    out = out.at[idx, :, idx, :].set(blocks)
    return out.reshape(2 * nz, 2 * nz)


def observe_heading(state: EKFState, phi_meas, sigma_heading) -> EKFState:
    """Direct heading pseudo-observation, Joseph form.

    Reference: ``EKF::observeHeading`` (EKF.cpp:328-352) with
    sigma = 0.01 deg (EKF.cpp:337).  Runs every control step when
    ``switch_heading_known`` is on (test/main.cpp:168).
    """
    v = wrap_angle(phi_meas - state.x[2])
    x, p = joseph_update_scalar(state.x, state.p, v, sigma_heading**2, idx=2)
    x = x.at[2].set(wrap_angle(x[2]))
    return state._replace(x=x, p=p)
