"""Per-particle motion prediction and heading pseudo-observation.

Reference: ``PF::predict`` (PF.cpp:419-471) and ``PF::observeHeading``
(PF.cpp:382-417), both executed in a host loop over particles
(test/main.cpp:279-286); here a single ``vmap`` over the ensemble.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import bmm_small, quad_small, sym
from conan_slam.filters.pf.state import ParticleEnsemble
from conan_slam.models import motion


def predict(ens: ParticleEnsemble, v, swa, q_cov, wheel_base, dt) -> ParticleEnsemble:
    """Pose-covariance propagation + mean motion (reference PF.cpp:433-458).

    Note the PF propagates only the 3x3 pose block — per-particle maps are
    conditionally independent given the trajectory (Rao-Blackwellization).
    """
    gv, gu = motion.jacobians(ens.pose, v, swa, wheel_base, dt)  # (N,3,3) (N,3,2)
    # Tiny-block algebra via broadcast ops (see core.linalg.bmm_small).
    guq = quad_small(gu, jnp.broadcast_to(q_cov, gu.shape[:-2] + (2, 2)))
    cov = sym(quad_small(gv, ens.pose_cov) + guq)
    pose = motion.step(ens.pose, v, swa, wheel_base, dt)
    return ens._replace(pose=pose, pose_cov=cov)


def observe_heading(ens: ParticleEnsemble, phi_meas, sigma_heading) -> ParticleEnsemble:
    """Per-particle Joseph-form update on the heading component
    (reference PF.cpp:396-404 with sigma = 0.01 deg, PF.cpp:391)."""
    r = sigma_heading**2

    def one(pose, cov):
        v = wrap_angle(phi_meas - pose[2])
        pc = cov[:, 2]
        s = cov[2, 2] + r
        w = pc / s
        pose_new = pose + w * v
        pose_new = pose_new.at[2].set(wrap_angle(pose_new[2]))
        outer_wpc = jnp.outer(w, pc)
        cov_new = sym(cov - outer_wpc - outer_wpc.T + s * jnp.outer(w, w))
        return pose_new, cov_new

    pose, cov = jax.vmap(one)(ens.pose, ens.pose_cov)
    return ens._replace(pose=pose, pose_cov=cov)
