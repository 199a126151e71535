"""EKF-SLAM estimator: one joint Gaussian over pose + landmark map.

Device-resident equivalent of the reference ``EKF`` engine
(EKF.h:5-340, EKF.cpp:1-496); see the submodules for per-kernel mapping.
"""

from conan_slam.filters.ekf.state import EKFState, init_state, init_state_with_map
from conan_slam.filters.ekf.predict import predict
from conan_slam.filters.ekf.observe import observe_heading
from conan_slam.filters.ekf.associate import (
    AssociationResult,
    associate_gated,
    associate_known,
)
from conan_slam.filters.ekf.update import (
    batch_update,
    fused_frame_step,
    fused_frame_update,
    sequential_update,
    update,
)
from conan_slam.filters.ekf.augment import augment
from conan_slam.filters.ekf.fastframe import frame_factors, frame_predict_heading

from conan_slam.filters.common import CompactObs


def observation_step(
    state: EKFState,
    obs: CompactObs,
    r_cov,
    *,
    association_known: bool,
    batch: bool,
    gate_reject: float,
    gate_augment: float,
    return_nis: bool = False,
):
    """Associate -> update -> augment, mirroring the driver's observation
    branch (reference test/main.cpp:183-197).  With ``return_nis`` also
    returns the frame's normalised innovation squared per associated
    measurement (the chi^2_2 consistency statistic; zero when nothing
    associated)."""
    if association_known:
        assoc = associate_known(state, obs)
    else:
        assoc = associate_gated(state, obs, r_cov, gate_reject, gate_augment)
    # Skip the heavy kernels when a frame has nothing for them (after the map
    # stabilises, augment runs on almost no frames; lax.cond executes one
    # branch on the device, so the skip is real).
    import jax
    import jax.numpy as jnp

    state, nis = jax.lax.cond(
        jnp.any(assoc.known_mask),
        lambda s: (lambda st_nis: (st_nis[0], st_nis[1].astype(jnp.float32)))(
            update(s, obs, assoc.slots, assoc.known_mask, r_cov, batch,
                   return_nis=True)),
        lambda s: (s, jnp.zeros((), jnp.float32)),
        state,
    )
    state = jax.lax.cond(
        jnp.any(assoc.new_mask),
        lambda s: augment(s, obs, assoc.new_mask, r_cov),
        lambda s: s,
        state,
    )
    if return_nis:
        n_meas = jnp.maximum(jnp.sum(assoc.known_mask.astype(nis.dtype)), 1.0)
        return state, nis / n_meas
    return state


__all__ = [
    "EKFState",
    "init_state",
    "init_state_with_map",
    "predict",
    "observe_heading",
    "AssociationResult",
    "associate_known",
    "associate_gated",
    "batch_update",
    "sequential_update",
    "update",
    "augment",
    "observation_step",
]
