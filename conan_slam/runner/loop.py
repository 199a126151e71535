"""End-to-end simulation loops as jitted ``lax.scan`` programs.

Reference: the two inline ``while (iwp ...)`` driver loops in
test/main.cpp:132-200 (EKF) and 204-335 (PF).  Here each loop is a single
pure step function scanned over a static step count with a ``done`` flag
(the reference's loop-exit condition), compiled once and run entirely
on device — no host round-trips inside the hot loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.config import SlamConfig
from conan_slam.filters import ekf as ekf_mod
from conan_slam.filters import pf as pf_mod
from conan_slam.filters.common import compact
from conan_slam.models import motion
from conan_slam.sim import sensor_sim
from conan_slam.sim.steering import SteerState, init_steer_state, steer
from conan_slam.sim.world import World


class NoiseCovs(NamedTuple):
    """True and filter (inflated) noise covariances.

    Reference test/main.cpp:93-129: Q/R from the sigmas; QE/RE inflated when
    ``switch_inflate_noise`` (QE=2Q; RE=8R for EKF, 2R for PF).
    """

    q: jax.Array    # (2, 2) true control noise
    r: jax.Array    # (2, 2) true observation noise
    qe: jax.Array   # (2, 2) filter control noise
    re: jax.Array   # (2, 2) filter observation noise


def make_noise(cfg: SlamConfig, estimator: str = "ekf") -> NoiseCovs:
    q = jnp.diag(jnp.asarray([cfg.sigma_v**2, cfg.sigma_swa**2], jnp.float32))
    r = jnp.diag(jnp.asarray([cfg.sigma_r**2, cfg.sigma_b**2], jnp.float32))
    if cfg.switch_inflate_noise:
        r_mult = cfg.r_inflate_ekf if estimator == "ekf" else cfg.r_inflate_pf
        return NoiseCovs(q=q, r=r, qe=cfg.q_inflate * q, re=r_mult * r)
    return NoiseCovs(q=q, r=r, qe=q, re=r)


class EKFSimCarry(NamedTuple):
    steer: SteerState
    x_true: jax.Array       # (3,) ground-truth pose
    state: ekf_mod.EKFState
    step_in_frame: jax.Array  # () int32 control steps since last observation
    key: jax.Array


class SimOutputs(NamedTuple):
    x_true: jax.Array   # (T, 3)
    x_est: jax.Array    # (T, 3)
    done: jax.Array     # (T,) bool
    n_active: jax.Array  # (T,) int32 map size
    # Filter-consistency observability (SURVEY.md section 5): for the EKF,
    # the frame's normalised innovation squared per associated measurement
    # (chi^2_2-distributed when consistent); for the PF, the effective
    # sample size.  Zero on non-observation steps.
    consistency: jax.Array  # (T,) float32


def _advance_truth(carry_steer, x_true, world, cfg, key):
    """Steering controller + ground-truth motion + noisy odometry.

    Shared by both estimators (reference test/main.cpp:140-162, 255-277).
    """
    st = steer(
        carry_steer,
        x_true,
        world.waypoints,
        at_waypoint=cfg.at_waypoint,
        rate_swa=cfg.rate_swa,
        max_swa=cfg.max_swa,
        dt=cfg.dt_controls,
    )
    x_true_new = motion.step(x_true, cfg.velocity, st.swa, cfg.wheel_base, cfg.dt_controls)
    x_true_new = jnp.where(st.done, x_true, x_true_new)
    vn, swan = sensor_sim.add_control_noise(
        key, cfg.velocity, st.swa, cfg.sigma_v, cfg.sigma_swa, cfg.switch_control_noise
    )
    return st, x_true_new, vn, swan


def ekf_sim_step(carry: EKFSimCarry, _, *, cfg: SlamConfig, world: World, noise: NoiseCovs):
    key, k_ctrl, k_obs = jax.random.split(carry.key, 3)
    was_done = carry.steer.done

    st, x_true, vn, swan = _advance_truth(carry.steer, carry.x_true, world, cfg, k_ctrl)

    # --- EKF predict (reference main.cpp:165) ---
    state = ekf_mod.predict(carry.state, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)

    # --- heading pseudo-observation every control step (main.cpp:168) ---
    if cfg.switch_heading_known:
        state = ekf_mod.observe_heading(state, x_true[2], cfg.sigma_heading)

    # --- observation update every observe_interval steps (main.cpp:171-199) ---
    step_in_frame = carry.step_in_frame + 1
    do_obs = jnp.logical_and(step_in_frame >= cfg.observe_interval, jnp.logical_not(st.done))
    step_in_frame = jnp.where(do_obs, 0, step_in_frame)

    nz = min(world.num_landmarks, cfg.max_observations())

    def obs_branch(state):
        obs_full = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
        obs_full = sensor_sim.add_observation_noise(
            k_obs, obs_full, cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise
        )
        obs = compact(obs_full, nz)
        return ekf_mod.observation_step(
            state,
            obs,
            noise.re,
            association_known=cfg.switch_association_known,
            batch=cfg.switch_batch_update,
            gate_reject=cfg.gate_reject,
            gate_augment=cfg.gate_augment,
            return_nis=True,
        )

    state, frame_nis = jax.lax.cond(
        do_obs, obs_branch, lambda s: (s, jnp.float32(0.0)), state
    )

    # Freeze filter state once the course is complete.
    state = jax.tree_util.tree_map(
        lambda new, old: jnp.where(was_done, old, new), state, carry.state
    )

    out = SimOutputs(
        x_true=x_true, x_est=state.x[:3], done=st.done, n_active=state.n_active,
        consistency=frame_nis,
    )
    return EKFSimCarry(steer=st, x_true=x_true, state=state, step_in_frame=step_in_frame, key=key), out


def ekf_precomp_frame_step(state, frame, *, cfg: SlamConfig, world: World, noise: NoiseCovs):
    """Frame step against a host-precomputed truth + observation rollout.

    All sequential scalar simulation work (steering, truth motion, sensor
    visibility/compaction) and all RNG happen outside the device loop
    (sim.precompute + bulk noise pregeneration), leaving only filter compute
    per frame — the sim chain's many tiny kernels would otherwise sit on the
    device's critical path.
    """
    (x_true_f, swa_f, active_f, done_f, ctrl_noise_f,
     z_true_f, ids_f, zmask_f, obs_noise_f) = frame

    if cfg.switch_control_noise:
        vns = cfg.velocity + ctrl_noise_f[:, 0] * cfg.sigma_v
        swans = swa_f + ctrl_noise_f[:, 1] * cfg.sigma_swa
    else:
        vns = jnp.full_like(swa_f, cfg.velocity)
        swans = swa_f

    z = z_true_f
    if cfg.switch_sensor_noise:
        scale = jnp.asarray([cfg.sigma_r, cfg.sigma_b], z.dtype)
        z = z + obs_noise_f * scale
    from conan_slam.filters.common import CompactObs

    obs = CompactObs(
        z=jnp.where(zmask_f[:, None], z, 0.0), ids=ids_f, mask=zmask_f
    )

    live = jnp.logical_not(done_f[-1])
    if cfg.switch_association_known:
        # Known association is a table lookup independent of the frame's
        # predict/heading factors, so the whole frame (factors + observe +
        # update) is one call (ekf.update.fused_frame_step).
        assoc = ekf_mod.associate_known(state, obs)
        state, pose_trace, frame_nis = ekf_mod.fused_frame_step(
            state, vns, swans, x_true_f[:, 2], active_f, noise.qe, obs,
            assoc.slots, jnp.logical_and(assoc.known_mask, live), noise.re,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known,
        )
    else:
        state, pose_trace, vmat, bmat = ekf_mod.frame_factors(
            state, vns, swans, x_true_f[:, 2], active_f,
            noise.qe, cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known,
        )
        assoc = ekf_mod.associate_gated(
            state, obs, noise.re, cfg.gate_reject, cfg.gate_augment,
            vmat, bmat,
        )
        state, frame_nis = ekf_mod.fused_frame_update(
            state, vmat, bmat, obs, assoc.slots,
            jnp.logical_and(assoc.known_mask, live), noise.re,
            return_nis=True,
        )
    if cfg.enable_augment:
        new_mask = jnp.logical_and(assoc.new_mask, live)
        state = jax.lax.cond(
            jnp.any(new_mask),
            lambda s: ekf_mod.augment(s, obs, new_mask, noise.re),
            lambda s: s,
            state,
        )

    interval = x_true_f.shape[0]
    outs = SimOutputs(
        x_true=x_true_f,
        x_est=pose_trace.at[-1].set(state.x[:3]),
        done=done_f,
        n_active=jnp.broadcast_to(state.n_active, (interval,)),
        consistency=jnp.zeros((interval,), jnp.float32).at[-1].set(frame_nis),
    )
    return state, outs


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps"), donate_argnums=())
def _run_precomp(world, cfg, key, truth_dev, obs_dev, n_steps, init_state):
    interval = cfg.observe_interval
    n_frames = n_steps // interval
    x_true, swa, active, done = truth_dev
    z_true, ids, zmask = obs_dev
    nz = z_true.shape[1]

    k_ctrl, k_obs = jax.random.split(key)
    ctrl_noise = jax.random.normal(k_ctrl, (n_frames, interval, 2), jnp.float32)
    obs_noise = jax.random.normal(k_obs, (n_frames, nz, 2), jnp.float32)
    frames = (
        x_true.reshape(n_frames, interval, 3),
        swa.reshape(n_frames, interval),
        active.reshape(n_frames, interval),
        done.reshape(n_frames, interval),
        ctrl_noise,
        z_true,
        ids,
        zmask,
        obs_noise,
    )
    noise = make_noise(cfg, "ekf")
    step = functools.partial(
        ekf_precomp_frame_step, cfg=cfg, world=world, noise=noise
    )
    with jax.default_matmul_precision("highest"):
        state, outs = jax.lax.scan(
            step, init_state, frames, unroll=min(cfg.scan_unroll, n_frames)
        )
    outs = jax.tree_util.tree_map(
        lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]), outs
    )
    return state, outs


def precompute_rollout(world: World, cfg: SlamConfig, n_steps: int):
    """Host-side truth + observation rollout for ``run_ekf_slam_precomputed``.

    Seed-independent (the rollout is the deterministic truth trajectory and
    visibility schedule; all noise is drawn on device from the run key), so
    callers timing multiple seeds of the same workload should compute it
    ONCE and pass it via ``precomputed=`` — recomputing it per run adds
    ~20 us/frame of pure host work to the measurement.
    """
    import numpy as np

    from conan_slam.sim.precompute import rollout_observations, rollout_truth

    interval = cfg.observe_interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    roll = rollout_truth(np.asarray(world.waypoints), cfg, n_steps)
    truth_dev = (
        jnp.asarray(roll.x_true),
        jnp.asarray(roll.swa),
        jnp.asarray(roll.active),
        jnp.asarray(roll.done),
    )
    nz = min(world.num_landmarks, cfg.max_observations())
    obs_roll = rollout_observations(
        roll.x_true, np.asarray(world.landmarks), cfg.max_range, nz, interval
    )
    obs_dev = (
        jnp.asarray(obs_roll.z_true),
        jnp.asarray(obs_roll.ids),
        jnp.asarray(obs_roll.mask),
    )
    return truth_dev, obs_dev


def run_ekf_slam_precomputed(
    world: World,
    cfg: SlamConfig,
    key: jax.Array,
    n_steps: int = 25_000,
    init_state: ekf_mod.EKFState | None = None,
    precomputed=None,
):
    """run_ekf_slam with the truth rollout precomputed on the host.

    Identical workload semantics (same truth trajectory as the on-device
    chain to float32 precision, same noise distributions); the device scan
    contains only filter compute.  ``precomputed`` takes the output of
    ``precompute_rollout`` to share the rollout across runs.
    Returns (final EKFState, SimOutputs).
    """
    interval = cfg.observe_interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    if precomputed is None:
        precomputed = precompute_rollout(world, cfg, n_steps)
    truth_dev, obs_dev = precomputed
    state0 = (
        init_state
        if init_state is not None
        else ekf_mod.init_state(cfg.max_landmarks, world.num_landmarks)
    )
    return _run_precomp(world, cfg, key, truth_dev, obs_dev, n_steps, state0)


def run_ekf_slam_precomputed_chunked(
    world: World,
    cfg: SlamConfig,
    key: jax.Array,
    n_steps: int,
    chunk_steps: int,
    init_state: ekf_mod.EKFState | None = None,
    precomputed=None,
    checkpoint_dir: str | None = None,
):
    """``run_ekf_slam_precomputed`` as sequential same-shape dispatches.

    Splits the horizon into ``chunk_steps``-sized scans with the filter state
    carried between them.  Identical math to the single-scan driver (the
    rollout is sliced; noise keys are folded per chunk, so the realisation
    differs from the one-shot run only like a different seed does).  Use for
    long horizons at large D where one device program would run for minutes:
    every chunk reuses ONE compiled program, and the host sees progress (and
    can checkpoint) between chunks.  Returns (state, stacked SimOutputs) like
    the one-shot driver.

    ``checkpoint_dir`` enables restartable execution (SURVEY.md section 5 —
    the reference serialises nothing, test/main.cpp:106-108): after each
    chunk the filter state and accumulated outputs are checkpointed
    (utils.checkpoint / orbax), and a rerun with the same arguments resumes
    from the latest complete chunk.  Because chunk boundaries and per-chunk
    noise keys (``fold_in(key, c)``) are deterministic in the arguments, a
    killed-and-resumed run produces bit-identical trajectories to an
    uninterrupted one (asserted in tests/test_utils.py).
    """
    interval = cfg.observe_interval
    chunk_steps = ((chunk_steps + interval - 1) // interval) * interval
    n_steps = ((n_steps + interval - 1) // interval) * interval
    if precomputed is None:
        precomputed = precompute_rollout(world, cfg, n_steps)
    truth_dev, obs_dev = precomputed
    if truth_dev[0].shape[0] < n_steps:
        raise ValueError(
            f"precomputed truth rollout covers {truth_dev[0].shape[0]} steps "
            f"but n_steps={n_steps} (rounded to whole frames) was requested"
        )
    if obs_dev[0].shape[0] < n_steps // interval:
        raise ValueError(
            f"precomputed observation rollout covers {obs_dev[0].shape[0]} "
            f"frames but {n_steps // interval} are needed for n_steps={n_steps}"
        )
    state = (
        init_state
        if init_state is not None
        else ekf_mod.init_state(cfg.max_landmarks, world.num_landmarks)
    )
    outs_list = []
    n_chunks = (n_steps + chunk_steps - 1) // chunk_steps

    def chunk_bounds(c):
        return c * chunk_steps, min((c + 1) * chunk_steps, n_steps)

    def outs_template(n):
        return SimOutputs(
            x_true=jnp.zeros((n, 3), jnp.float32),
            x_est=jnp.zeros((n, 3), jnp.float32),
            done=jnp.zeros((n,), bool),
            n_active=jnp.zeros((n,), jnp.int32),
            consistency=jnp.zeros((n,), jnp.float32),
        )

    start_chunk = 0
    if checkpoint_dir is not None:
        import json
        import os

        from conan_slam.utils import checkpoint as ckpt_mod

        # Resume from the longest PREFIX of checkpoints whose recorded
        # boundaries AND run identity match this run's; a chunk from an
        # incompatible earlier run (different chunking, key, config, horizon
        # or world) is treated as absent.  Each chunk stores only ITS outputs
        # (constant I/O per chunk) plus the carried state.
        import hashlib

        import numpy as np

        ident = hashlib.sha256()
        ident.update(np.asarray(key).tobytes())
        ident.update(repr(cfg).encode())
        ident.update(str(n_steps).encode())
        ident.update(np.asarray(world.landmarks).tobytes())
        ident.update(np.asarray(world.waypoints).tobytes())
        run_id = ident.hexdigest()[:16]

        def meta_path(c):
            return os.path.join(checkpoint_dir, f"chunk_{c:05d}.meta.json")

        usable = 0
        while usable < n_chunks and os.path.exists(meta_path(usable)):
            with open(meta_path(usable)) as f:
                meta = json.load(f)
            s0, s1 = chunk_bounds(usable)
            if (
                meta.get("s0") != s0
                or meta.get("s1") != s1
                or meta.get("run_id", run_id) != run_id
            ):
                break
            usable += 1
        if usable:
            for c in range(usable):
                s0, s1 = chunk_bounds(c)
                template = {"state": state, "outs": outs_template(s1 - s0)}
                restored = ckpt_mod.restore(
                    os.path.join(checkpoint_dir, f"chunk_{c:05d}"), template
                )
                outs_list.append(restored["outs"])
            state = restored["state"]
            start_chunk = usable
    for c in range(start_chunk, n_chunks):
        # A ragged tail chunk compiles its own (smaller) program once.
        s0, s1 = chunk_bounds(c)
        f0, f1 = s0 // interval, s1 // interval
        t_slice = tuple(a[s0:s1] for a in truth_dev)
        o_slice = tuple(a[f0:f1] for a in obs_dev)
        state, outs = _run_precomp(
            world, cfg, jax.random.fold_in(key, c), t_slice, o_slice,
            s1 - s0, state,
        )
        outs_list.append(outs)
        if checkpoint_dir is not None:
            import json
            import os

            from conan_slam.utils import checkpoint as ckpt_mod

            ckpt_mod.save(
                os.path.join(checkpoint_dir, f"chunk_{c:05d}"),
                {"state": state, "outs": outs},
            )
            os.makedirs(checkpoint_dir, exist_ok=True)
            with open(
                os.path.join(checkpoint_dir, f"chunk_{c:05d}.meta.json"), "w"
            ) as f:
                json.dump({"s0": s0, "s1": s1, "chunk_steps": chunk_steps,
                           "run_id": run_id}, f)
    outs_all = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *outs_list
    )
    return state, outs_all


class PFSimCarry(NamedTuple):
    steer: SteerState
    x_true: jax.Array
    ens: pf_mod.ParticleEnsemble
    step_in_frame: jax.Array
    key: jax.Array


def pf_sim_step(carry: PFSimCarry, _, *, cfg: SlamConfig, world: World, noise: NoiseCovs):
    key, k_ctrl, k_obs, k_step = jax.random.split(carry.key, 4)
    was_done = carry.steer.done

    st, x_true, vn, swan = _advance_truth(carry.steer, carry.x_true, world, cfg, k_ctrl)

    # --- per-particle predict + heading observation (main.cpp:279-286) ---
    ens = pf_mod.predict(carry.ens, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
    if cfg.switch_heading_known:
        ens = pf_mod.observe_heading(ens, x_true[2], cfg.sigma_heading)

    step_in_frame = carry.step_in_frame + 1
    do_obs = jnp.logical_and(step_in_frame >= cfg.observe_interval, jnp.logical_not(st.done))
    step_in_frame = jnp.where(do_obs, 0, step_in_frame)

    nz = min(world.num_landmarks, cfg.max_observations())

    def obs_branch(ens):
        obs_full = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
        obs_full = sensor_sim.add_observation_noise(
            k_obs, obs_full, cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise
        )
        obs = compact(obs_full, nz)
        return pf_mod.observation_step(
            ens,
            obs,
            noise.re,
            k_step,
            num_effective=cfg.num_effective,
            sample_proposal_on=cfg.switch_sample_proposal,
            resample_on=cfg.switch_resample,
            proposal_relinearize=cfg.proposal_relinearize,
            resample_kind=cfg.pf_resample_kind,
            roughening=cfg.pf_roughening,
        )

    ens = jax.lax.cond(do_obs, obs_branch, lambda e: e, ens)

    ens = jax.tree_util.tree_map(
        lambda new, old: jnp.where(was_done, old, new), ens, carry.ens
    )
    out = SimOutputs(
        x_true=x_true,
        x_est=pf_mod.mean_pose(ens),
        done=st.done,
        n_active=ens.n_active,
        consistency=pf_mod.effective_count(pf_mod.normalized_weights(ens)),
    )
    return PFSimCarry(steer=st, x_true=x_true, ens=ens, step_in_frame=step_in_frame, key=key), out


def pf_frame_step(carry: PFSimCarry, _, *, cfg: SlamConfig, world: World, noise: NoiseCovs):
    """One observation frame of the PF: ``observe_interval`` predict+heading
    sub-steps traced inline, then ONE observation block.

    Same frame-batching lesson as ``ekf_frame_step``: the per-control-step
    scan paid its ``lax.cond`` barriers and dispatch overhead 6x per
    observation; per-particle throughput is latency-bound (the op chain),
    not compute- or memory-bound, so cutting the serial chain per frame is the lever.
    The predict/heading sub-steps touch only pose/pose_cov, so the done-
    freeze selects just those leaves (the map leaves pass through
    untouched).  Statistically identical workload (the reference fires the
    observation every 6th control step, test/main.cpp:249-290); the noise
    realisation differs from the per-step driver like a different seed does.
    """
    interval = cfg.observe_interval
    key, k_obs, k_step = jax.random.split(carry.key, 3)
    steer_state, x_true, ens = carry.steer, carry.x_true, carry.ens
    sub_outs = []
    for k in range(interval):
        was_done = steer_state.done
        k_ctrl = jax.random.fold_in(key, k)
        steer_state, x_true, vn, swan = _advance_truth(
            steer_state, x_true, world, cfg, k_ctrl
        )
        new_ens = pf_mod.predict(ens, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
        if cfg.switch_heading_known:
            new_ens = pf_mod.observe_heading(new_ens, x_true[2], cfg.sigma_heading)
        ens = ens._replace(
            pose=jnp.where(was_done, ens.pose, new_ens.pose),
            pose_cov=jnp.where(was_done, ens.pose_cov, new_ens.pose_cov),
        )
        sub_outs.append(
            SimOutputs(
                x_true=x_true, x_est=pf_mod.mean_pose(ens),
                done=steer_state.done, n_active=ens.n_active,
                consistency=jnp.float32(0.0),
            )
        )

    nz = min(world.num_landmarks, cfg.max_observations())

    def obs_branch(ens):
        obs_full = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
        obs_full = sensor_sim.add_observation_noise(
            k_obs, obs_full, cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise
        )
        obs = compact(obs_full, nz)
        return pf_mod.observation_step(
            ens, obs, noise.re, k_step,
            num_effective=cfg.num_effective,
            sample_proposal_on=cfg.switch_sample_proposal,
            resample_on=cfg.switch_resample,
            proposal_relinearize=cfg.proposal_relinearize,
            resample_kind=cfg.pf_resample_kind,
            roughening=cfg.pf_roughening,
        )

    ens = jax.lax.cond(
        jnp.logical_not(steer_state.done), obs_branch, lambda e: e, ens
    )
    sub_outs[-1] = sub_outs[-1]._replace(
        x_est=pf_mod.mean_pose(ens), n_active=ens.n_active,
        consistency=pf_mod.effective_count(pf_mod.normalized_weights(ens)),
    )
    outs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *sub_outs)
    new_carry = PFSimCarry(
        steer=steer_state, x_true=x_true, ens=ens,
        step_in_frame=jnp.int32(0), key=key,
    )
    return new_carry, outs


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run_pf_slam(world: World, cfg: SlamConfig, key: jax.Array, n_steps: int = 25_000):
    """Full FastSLAM 2.0 valet-loop simulation (reference test/main.cpp:204-335).

    With ``cfg.fast_frame`` (the default) the scan runs over observation
    frames (``pf_frame_step``); ``fast_frame=False`` keeps the per-control-
    step scan (``pf_sim_step``).

    Whole-frame carry semantics: the fast_frame path rounds ``n_steps`` UP
    to whole observation frames — a partial final frame still executes all
    of its sub-steps plus the end-of-frame observation, so the returned
    carry/ensemble has advanced to the frame boundary (outputs are trimmed
    to exactly ``n_steps`` rows, the carry is not).  Pass
    ``n_steps % cfg.observe_interval == 0`` for carry parity with the
    per-step driver."""
    noise = make_noise(cfg, "pf")
    carry = PFSimCarry(
        steer=init_steer_state(cfg.number_loops),
        x_true=jnp.zeros((3,), jnp.float32),
        ens=pf_mod.init_ensemble(cfg.num_particles, cfg.max_landmarks, world.num_landmarks),
        step_in_frame=jnp.int32(0),
        key=key,
    )
    if cfg.fast_frame:
        interval = cfg.observe_interval
        n_frames = (n_steps + interval - 1) // interval
        step = functools.partial(pf_frame_step, cfg=cfg, world=world, noise=noise)
        with jax.default_matmul_precision("highest"):
            carry, outs = jax.lax.scan(
                step, carry, None, length=n_frames,
                unroll=min(cfg.scan_unroll, n_frames),
            )
        # Trim the whole-frames rounding so both driver paths return exactly
        # n_steps rows.
        outs = jax.tree_util.tree_map(
            lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])[
                :n_steps
            ],
            outs,
        )
        return carry, outs
    step = functools.partial(pf_sim_step, cfg=cfg, world=world, noise=noise)
    with jax.default_matmul_precision("highest"):
        return jax.lax.scan(
            step, carry, None, length=n_steps,
            unroll=min(cfg.scan_unroll, n_steps),
        )


def ekf_frame_step(carry: EKFSimCarry, _, *, cfg: SlamConfig, world: World, noise: NoiseCovs):
    """One observation frame: ``observe_interval`` control sub-steps unrolled
    (traced inline, fused by XLA across sub-steps) followed by one observation
    update.  Scanning over frames instead of control steps cuts per-iteration
    launch overhead ~interval-fold while computing the identical
    sequence (the reference fires the observation every 6th control step,
    test/main.cpp:171-174)."""
    interval = cfg.observe_interval
    key, k_obs = jax.random.split(carry.key)
    sub_outs = []
    steer_state, x_true, state = carry.steer, carry.x_true, carry.state

    fused = cfg.fast_frame and cfg.fused_obs and cfg.switch_batch_update
    # With known association the association is a table lookup independent of
    # the frame factors, so factors + observe + update are one call
    # (filters.ekf.update.fused_frame_step) after the obs buffer is
    # assembled below.
    fused_step = fused and cfg.switch_association_known
    if cfg.fast_frame:
        # Rank-compounded frame update (filters.ekf.fastframe): advance the
        # cheap O(1) truth/steering chain per sub-step, then apply all
        # predict+heading covariance work as one symmetric rank update.
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
            sub_outs.append(
                SimOutputs(
                    x_true=x_true, x_est=state.x[:3], done=steer_state.done,
                    n_active=state.n_active, consistency=jnp.float32(0.0),
                )
            )
        frame_args = (
            jnp.stack(vns), jnp.stack(swans), jnp.stack(phis), jnp.stack(actives),
            noise.qe, cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
            cfg.switch_heading_known,
        )
        if fused_step:
            pose_trace = None   # produced by the one-shot frame step below
        elif fused:
            # P is rewritten exactly once per frame: the frame's factored
            # predict+heading correction folds into the measurement update
            # (filters.ekf.update.fused_frame_update).
            state, pose_trace, vmat, bmat = ekf_mod.frame_factors(
                state, *frame_args
            )
        else:
            state, pose_trace = ekf_mod.frame_predict_heading(
                state, *frame_args, return_pose_trace=True
            )
    else:
        for k in range(interval):
            was_done = steer_state.done
            k_ctrl = jax.random.fold_in(key, k)
            steer_state, x_true, vn, swan = _advance_truth(
                steer_state, x_true, world, cfg, k_ctrl
            )
            new_state = ekf_mod.predict(state, vn, swan, noise.qe, cfg.wheel_base, cfg.dt_controls)
            if cfg.switch_heading_known:
                new_state = ekf_mod.observe_heading(new_state, x_true[2], cfg.sigma_heading)
            state = jax.tree_util.tree_map(
                lambda new, old: jnp.where(was_done, old, new), new_state, state
            )
            sub_outs.append(
                SimOutputs(
                    x_true=x_true, x_est=state.x[:3], done=steer_state.done,
                    n_active=state.n_active, consistency=jnp.float32(0.0),
                )
            )

    nz = min(world.num_landmarks, cfg.max_observations())

    if fused:
        # Unconditional fused path: a done/empty frame degenerates to a
        # zero-factor, all-masked update (exact no-op) — no lax.cond needed.
        obs_full = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
        obs_full = sensor_sim.add_observation_noise(
            k_obs, obs_full, cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise
        )
        obs = compact(obs_full, nz)
        live = jnp.logical_not(steer_state.done)
        if fused_step:
            assoc = ekf_mod.associate_known(state, obs)
            state, pose_trace, frame_nis = ekf_mod.fused_frame_step(
                state, *frame_args[:4], noise.qe, obs, assoc.slots,
                jnp.logical_and(assoc.known_mask, live), noise.re,
                cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading,
                cfg.switch_heading_known,
            )
        else:
            # Gate against the virtual covariance P + V B V^T (the pending
            # frame factors) — same post-predict gating semantics as the
            # materialised path without rewriting P.
            assoc = ekf_mod.associate_gated(
                state, obs, noise.re, cfg.gate_reject, cfg.gate_augment,
                vmat, bmat,
            )
            state, frame_nis = ekf_mod.fused_frame_update(
                state, vmat, bmat, obs, assoc.slots,
                jnp.logical_and(assoc.known_mask, live), noise.re,
                return_nis=True,
            )
        if cfg.enable_augment:
            new_mask = jnp.logical_and(assoc.new_mask, live)
            state = jax.lax.cond(
                jnp.any(new_mask),
                lambda s: ekf_mod.augment(s, obs, new_mask, noise.re),
                lambda s: s,
                state,
            )
    else:
        def obs_branch(state):
            obs_full = sensor_sim.get_observations(x_true, world.landmarks, cfg.max_range)
            obs_full = sensor_sim.add_observation_noise(
                k_obs, obs_full, cfg.sigma_r, cfg.sigma_b, cfg.switch_sensor_noise
            )
            obs = compact(obs_full, nz)
            return ekf_mod.observation_step(
                state,
                obs,
                noise.re,
                association_known=cfg.switch_association_known,
                batch=cfg.switch_batch_update,
                gate_reject=cfg.gate_reject,
                gate_augment=cfg.gate_augment,
                return_nis=True,
            )

        state, frame_nis = jax.lax.cond(
            jnp.logical_not(steer_state.done), obs_branch,
            lambda s: (s, jnp.float32(0.0)), state,
        )
    # Per-sub-step pose estimates come from the exact pose tracking inside
    # the compounding (mean of the filter at each sub-step).
    if cfg.fast_frame:
        for k in range(interval):
            sub_outs[k] = sub_outs[k]._replace(x_est=pose_trace[k])
    # The frame's last sub-step output reflects the post-update estimate.
    frame_cons = frame_nis
    sub_outs[-1] = sub_outs[-1]._replace(
        x_est=state.x[:3], n_active=state.n_active, consistency=frame_cons
    )

    outs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *sub_outs)
    new_carry = EKFSimCarry(
        steer=steer_state, x_true=x_true, state=state,
        step_in_frame=jnp.int32(0), key=key,
    )
    return new_carry, outs


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run_ekf_slam(
    world: World,
    cfg: SlamConfig,
    key: jax.Array,
    n_steps: int = 25_000,
    init_state: ekf_mod.EKFState | None = None,
):
    """Full EKF-SLAM valet-loop simulation (reference test/main.cpp:89-201).

    Scans over observation frames (``observe_interval`` control steps each);
    ``n_steps`` is rounded up to a whole number of frames.  Returns
    (final_carry, SimOutputs) with per-control-step trajectories.
    ``init_state`` overrides the empty-map start (e.g. a pre-built map from
    ``ekf.init_state_with_map`` or a restored checkpoint).
    """
    noise = make_noise(cfg, "ekf")
    carry = EKFSimCarry(
        steer=init_steer_state(cfg.number_loops),
        x_true=jnp.zeros((3,), jnp.float32),
        state=(
            init_state
            if init_state is not None
            else ekf_mod.init_state(cfg.max_landmarks, world.num_landmarks)
        ),
        step_in_frame=jnp.int32(0),
        key=key,
    )
    interval = cfg.observe_interval
    n_frames = (n_steps + interval - 1) // interval
    step = functools.partial(ekf_frame_step, cfg=cfg, world=world, noise=noise)
    # Covariance algebra needs true fp32 matmuls; the GPU's default float32
    # matmul precision is TF32, which destroys positive-definiteness
    # (SURVEY.md section 7.3).
    with jax.default_matmul_precision("highest"):
        carry, outs = jax.lax.scan(
            step, carry, None, length=n_frames,
            unroll=min(cfg.scan_unroll, n_frames),
        )
    # (n_frames, interval, ...) -> (n_frames * interval, ...).
    outs = jax.tree_util.tree_map(
        lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]), outs
    )
    return carry, outs
