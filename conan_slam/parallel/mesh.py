"""Device mesh construction for the SLAM engine.

The reference has no parallelism of any kind (single OS thread,
SURVEY.md section 2.2); the engine's scaling axes are:

- ``state``: row blocks of the joint EKF covariance (the sequence-parallel
  analogue over the state dimension, SURVEY.md section 5 "long-context" row),
- ``particles``: the particle ensemble (the data-parallel analogue).

XLA places the collectives from the mesh + PartitionSpecs and hands them to
NCCL; the GPUs of one host are joined all to all by NVLink, so the mesh
follows the algorithm, not a topology.  No hand-written transport exists.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

STATE_AXIS = "state"
PARTICLE_AXIS = "particles"


def make_mesh(
    axis_sizes: dict[str, int] | None = None, devices: Sequence[jax.Device] | None = None
) -> Mesh:
    """Build a mesh.  Default: all devices on the ``state`` axis.

    ``axis_sizes`` e.g. {"state": 4, "particles": 2}; total must not exceed
    the device count.
    """
    devices = list(devices if devices is not None else jax.devices())
    if not axis_sizes:
        axis_sizes = {STATE_AXIS: len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(dev_array, names)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
