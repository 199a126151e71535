"""Bicycle kinematics and its analytic Jacobians.

Reference: ``vehicleModel`` (slam.h:952-966) and the motion Jacobians
``Gv``/``Gu`` duplicated in ``EKF::predict`` (EKF.cpp:419-436) and
``PF::predict`` (PF.cpp:433-450).  Here the model and its linearisation live
in one place, are batched over leading axes (``vmap``-ready for the particle
ensemble), and return stacked matrices instead of writing into Eigen blocks.
"""

from __future__ import annotations

import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle


def step(pose, v, swa, wheel_base, dt):
    """One bicycle-model step.  ``pose`` is (..., 3) = (x, y, phi).

    x' = x + v dt cos(swa + phi)
    y' = y + v dt sin(swa + phi)
    phi' = wrap(phi + v dt sin(swa) / wb)          (reference slam.h:958-960)
    """
    phi = pose[..., 2]
    a = swa + phi
    return jnp.stack(
        [
            pose[..., 0] + v * dt * jnp.cos(a),
            pose[..., 1] + v * dt * jnp.sin(a),
            wrap_angle(phi + v * dt * jnp.sin(swa) / wheel_base),
        ],
        axis=-1,
    )


def jacobians(pose, v, swa, wheel_base, dt):
    """(Gv, Gu): d(step)/d(pose) (..., 3, 3) and d(step)/d(v, swa) (..., 3, 2).

    Reference: EKF.cpp:419-436.
    """
    phi = pose[..., 2]
    a = swa + phi
    sa, ca = jnp.sin(a), jnp.cos(a)
    one = jnp.ones_like(phi)
    zero = jnp.zeros_like(phi)
    gv = jnp.stack(
        [
            jnp.stack([one, zero, -v * dt * sa], axis=-1),
            jnp.stack([zero, one, v * dt * ca], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    gu = jnp.stack(
        [
            jnp.stack([dt * ca, -v * dt * sa], axis=-1),
            jnp.stack([dt * sa, v * dt * ca], axis=-1),
            jnp.stack(
                [
                    dt * jnp.sin(swa) / wheel_base * one,
                    v * dt * jnp.cos(swa) / wheel_base * one,
                ],
                axis=-1,
            ),
        ],
        axis=-2,
    )
    return gv, gu
