"""Fully-sharded EKF-SLAM simulation loop.

Composes the distributed kernels (parallel.dist_ekf) into the same
frame-structured ``lax.scan`` driver as runner.loop, with the joint
state/covariance row-block-sharded over the ``state`` mesh axis for the
whole run — the execution model for maps too large for one chip
(BASELINE.json config 5).  Truth/steering/association bookkeeping is
replicated (O(1) / O(num_landmarks) data).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.config import SlamConfig
from conan_slam.filters.common import compact
from conan_slam.parallel import dist_ekf
from conan_slam.parallel.mesh import STATE_AXIS
from conan_slam.runner.loop import (
    NoiseCovs,
    SimOutputs,
    _advance_truth,
    make_noise,
)
from conan_slam.sim import sensor_sim
from conan_slam.sim.steering import SteerState, init_steer_state
from conan_slam.sim.world import World


class DistEKFCarry(NamedTuple):
    steer: SteerState
    x_true: jax.Array
    x: jax.Array          # (Dp,) sharded padded mean
    p: jax.Array          # (Dp, Dp) row-block-sharded padded covariance
    n_active: jax.Array   # () int32 (replicated)
    table: jax.Array      # (num_ids,) int32 (replicated)
    key: jax.Array


def dist_ekf_frame_step(
    carry: DistEKFCarry, _, *, cfg: SlamConfig, world: World, noise: NoiseCovs, mesh
):
    """One observation frame on the sharded state.

    With ``cfg.fast_frame`` (the default) the whole frame — ``interval``
    predict+heading sub-steps compounded as a rank update, observe, and the
    Schur-style batched measurement update — runs as ONE shard_map kernel
    with three collective rounds (parallel.dist_fastframe), the distributed
    port of the single-chip fused frame; only the (rare-content) augment is
    a separate dispatch.  The legacy multi-dispatch composition (one
    shard_map per sub-step) remains under ``fast_frame=False``.
    """
    interval = cfg.observe_interval
    key, k_obs = jax.random.split(carry.key)
    steer_state, x_true = carry.steer, carry.x_true
    x, p = carry.x, carry.p

    outs = []
    if cfg.fast_frame:
        vns, swans, phis, actives = [], [], [], []
        for k in range(interval):
            was_done = steer_state.done
            k_ctrl = jax.random.fold_in(key, k)
            steer_state, x_true, vn, swan = _advance_truth(
                steer_state, x_true, world, cfg, k_ctrl
            )
            vns.append(vn)
            swans.append(swan)
            phis.append(x_true[2])
            actives.append(jnp.logical_not(was_done))
            outs.append(
                SimOutputs(
                    x_true=x_true, x_est=x[:3], done=steer_state.done,
                    n_active=carry.n_active, consistency=jnp.float32(0.0),
                )
            )
    else:
        for k in range(interval):
            was_done = steer_state.done
            k_ctrl = jax.random.fold_in(key, k)
            steer_state, x_true, vn, swan = _advance_truth(
                steer_state, x_true, world, cfg, k_ctrl
            )
            x_new, p_new = dist_ekf.sharded_predict(
                mesh, x, p, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls
            )
            if cfg.switch_heading_known:
                x_new, p_new = dist_ekf.sharded_observe_heading(
                    mesh, x_new, p_new, x_true[2], cfg.sigma_heading
                )
            x = jnp.where(was_done, x, x_new)
            p = jnp.where(was_done, p, p_new)
            outs.append(
                SimOutputs(
                    x_true=x_true, x_est=x[:3], done=steer_state.done,
                    n_active=carry.n_active, consistency=jnp.float32(0.0),
                )
            )

    nz = min(world.num_landmarks, cfg.max_observations())
    obs_full = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
    obs_full = sensor_sim.add_observation_noise(
        k_obs, obs_full, cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise
    )
    obs = compact(obs_full, nz)
    live = jnp.logical_not(steer_state.done)

    # Known-association bookkeeping on the replicated table.
    safe_ids = jnp.maximum(obs.ids, 0)
    slots = carry.table[safe_ids]
    known = jnp.logical_and(jnp.logical_and(obs.mask, slots >= 0), live)
    new_mask = jnp.logical_and(jnp.logical_and(obs.mask, slots < 0), live)

    cap = (x.shape[0] - 3) // 2
    frame_nis = jnp.float32(0.0)
    if cfg.fast_frame:
        from conan_slam.parallel.dist_fastframe import sharded_frame_update

        safe_slots = jnp.clip(slots, 0, cap - 1)
        x, p, frame_nis, pose_trace = sharded_frame_update(
            mesh, x, p,
            jnp.stack(vns), jnp.stack(swans), jnp.stack(phis),
            jnp.stack(actives),
            noise.qe, obs.z, safe_slots, known, noise.re,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known, gain_wire=cfg.dist_gain_wire,
        )
        for k in range(interval):
            outs[k] = outs[k]._replace(x_est=pose_trace[k])
    else:
        x, p = dist_ekf.sharded_observation_update(
            mesh, x, p, obs.z, jnp.maximum(slots, 0), known, noise.re,
            capacity=cap,
        )
    x, p, n_active, table = dist_ekf.sharded_augment(
        mesh, x, p, obs.z, obs.ids, new_mask, noise.re, carry.n_active, carry.table
    )

    outs[-1] = outs[-1]._replace(
        x_est=x[:3], n_active=n_active, consistency=frame_nis
    )
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)
    return (
        DistEKFCarry(
            steer=steer_state, x_true=x_true, x=x, p=p,
            n_active=n_active, table=table, key=key,
        ),
        stacked,
    )


def run_ekf_slam_sharded(
    world: World,
    cfg: SlamConfig,
    key: jax.Array,
    mesh,
    n_steps: int = 25_000,
    init_state=None,
):
    """Sharded analogue of runner.loop.run_ekf_slam.  ``init_state`` is an
    (unsharded) filters.ekf.EKFState to start from."""
    from conan_slam.filters import ekf as ekf_mod

    state0 = (
        init_state
        if init_state is not None
        else ekf_mod.init_state(cfg.max_landmarks, world.num_landmarks)
    )
    xs, ps = dist_ekf.shard_state(mesh, state0.x, state0.p)
    carry = DistEKFCarry(
        steer=init_steer_state(cfg.number_loops),
        x_true=jnp.zeros((3,), jnp.float32),
        x=xs,
        p=ps,
        n_active=state0.n_active,
        table=state0.table,
        key=key,
    )
    noise = make_noise(cfg, "ekf")
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    step = functools.partial(
        dist_ekf_frame_step, cfg=cfg, world=world, noise=noise, mesh=mesh
    )

    @jax.jit
    def run(carry):
        with jax.default_matmul_precision("highest"):
            return jax.lax.scan(step, carry, None, length=n_frames)

    carry, outs = run(carry)
    outs = jax.tree_util.tree_map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]), outs
    )
    return carry, outs
