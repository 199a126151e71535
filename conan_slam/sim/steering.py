"""Waypoint-following steering controller.

Functional, jit-safe re-design of the reference's ``computeSWA``
(slam.h:279-332) plus the driver's loop-restart logic (test/main.cpp:150-154).
The reference mutates ``iwp``/``swa`` in place and signals termination with
``iwp = 0``; here the controller is a pure function over a small integer/float
carry with an explicit ``done`` flag, so the whole simulation can run under
``lax.scan``.

Waypoint indices are 0-based (the reference uses 1-based, slam.h:294).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle


class SteerState(NamedTuple):
    swa: jax.Array        # () float32 current steering wheel angle
    iwp: jax.Array        # () int32 current waypoint index (0-based)
    loops_left: jax.Array  # () int32 remaining passes through the list
    done: jax.Array       # () bool  final waypoint reached, no loops left


def init_steer_state(number_loops: int) -> SteerState:
    return SteerState(
        swa=jnp.float32(0.0),
        iwp=jnp.int32(0),
        loops_left=jnp.int32(number_loops),
        done=jnp.asarray(False),
    )


def steer(state: SteerState, pose, waypoints, *, at_waypoint, rate_swa, max_swa, dt):
    """One controller tick: waypoint switching + rate/angle-limited steering.

    Mirrors reference slam.h:291-326: on reaching the current waypoint the
    target advances immediately (same tick); on passing the final waypoint the
    controller either restarts the list (one tick with unchanged steering,
    reference's early return at slam.h:301-303) or terminates.
    """
    n_wp = waypoints.shape[0]
    cwp = waypoints[state.iwp]
    d2 = jnp.sum((cwp - pose[:2]) ** 2)
    reached = d2 < at_waypoint**2

    iwp_next = state.iwp + reached.astype(jnp.int32)
    past_end = iwp_next >= n_wp
    restart = jnp.logical_and(past_end, state.loops_left > 1)
    finished = jnp.logical_and(past_end, jnp.logical_not(restart))

    loops_left = jnp.where(restart, state.loops_left - 1, state.loops_left)
    iwp_new = jnp.where(past_end, jnp.int32(0), iwp_next)

    # Steer towards the (possibly advanced) target waypoint.
    target = waypoints[jnp.minimum(iwp_next, n_wp - 1)]
    delta = wrap_angle(
        jnp.arctan2(target[1] - pose[1], target[0] - pose[0]) - pose[2] - state.swa
    )
    max_delta = rate_swa * dt
    delta = jnp.clip(delta, -max_delta, max_delta)
    swa_new = jnp.clip(state.swa + delta, -max_swa, max_swa)

    # Freeze steering on the pass-end tick (reference early-return) and after
    # termination.
    hold = jnp.logical_or(past_end, state.done)
    swa_new = jnp.where(hold, state.swa, swa_new)

    return SteerState(
        swa=swa_new,
        iwp=jnp.where(state.done, state.iwp, iwp_new),
        loops_left=loops_left,
        done=jnp.logical_or(state.done, finished),
    )
