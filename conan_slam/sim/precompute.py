"""Host-side ground-truth rollout.

The truth trajectory is *deterministic*: steering follows waypoints computed
from the true pose, and control/observation noise only enter the filter's
inputs, never the truth (reference test/main.cpp:140-160 — ``vehicleModel``
is driven by the noiseless ``swa``).  Interleaving this scalar chain with the
filter forces ~40 tiny kernels per frame onto the device, whose launch
overhead dominates the whole loop; rolling it out once on the host (trivial scalar
work) leaves the device scan with pure filter compute.

The arithmetic mirrors sim.steering.steer + models.motion.step in float32 so
the precomputed trajectory matches the on-device rollout to float precision
(validated in tests/test_sim.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from conan_slam.config import SlamConfig


class TruthRollout(NamedTuple):
    x_true: np.ndarray   # (T, 3) float32 pose after each control step
    swa: np.ndarray      # (T,) float32 steering angle used at each step
    active: np.ndarray   # (T,) bool  step executed (False after course done)
    done: np.ndarray     # (T,) bool  done flag after each step


def _wrap(a: np.float32) -> np.float32:
    return np.float32(np.remainder(np.float32(a) + np.float32(np.pi),
                                   np.float32(2 * np.pi)) - np.float32(np.pi))


def rollout_truth(
    waypoints: np.ndarray, cfg: SlamConfig, n_steps: int, use_native: bool = True
) -> TruthRollout:
    if use_native:
        # Native C++ rollout (native/hostsim.cpp): same float32 arithmetic,
        # ~50x the Python loop.  Fall back silently if the toolchain is
        # unavailable (parity validated in tests/test_sim.py).
        try:
            from conan_slam.native import rollout_truth_native

            x_true, swa, active, done = rollout_truth_native(waypoints, cfg, n_steps)
            return TruthRollout(x_true=x_true, swa=swa, active=active, done=done)
        except Exception:
            pass
    wp = np.asarray(waypoints, np.float32)
    n_wp = wp.shape[0]
    dt = np.float32(cfg.dt_controls)
    vel = np.float32(cfg.velocity)
    wb = np.float32(cfg.wheel_base)
    max_delta = np.float32(cfg.rate_swa) * dt
    max_swa = np.float32(cfg.max_swa)
    at2 = np.float32(cfg.at_waypoint) ** 2

    pose = np.zeros(3, np.float32)
    swa = np.float32(0.0)
    iwp = 0
    loops_left = int(cfg.number_loops)
    done = False

    xs = np.zeros((n_steps, 3), np.float32)
    swas = np.zeros((n_steps,), np.float32)
    actives = np.zeros((n_steps,), bool)
    dones = np.zeros((n_steps,), bool)

    for t in range(n_steps):
        was_done = done
        if not done:
            # steering (sim.steering.steer semantics)
            cwp = wp[iwp]
            d2 = (cwp[0] - pose[0]) ** 2 + (cwp[1] - pose[1]) ** 2
            reached = d2 < at2
            iwp_next = iwp + int(reached)
            past_end = iwp_next >= n_wp
            restart = past_end and loops_left > 1
            finished = past_end and not restart
            if restart:
                loops_left -= 1
            iwp = 0 if past_end else iwp_next
            if not past_end:
                target = wp[min(iwp_next, n_wp - 1)]
                delta = _wrap(
                    np.float32(np.arctan2(target[1] - pose[1], target[0] - pose[0]))
                    - pose[2] - swa
                )
                delta = np.float32(np.clip(delta, -max_delta, max_delta))
                swa = np.float32(np.clip(swa + delta, -max_swa, max_swa))
            done = done or finished
        # Motion freezes as soon as the course completes, including the
        # arrival step itself (runner.loop._advance_truth gates on the
        # post-steer done flag).
        if not done:
            a = swa + pose[2]
            pose = np.asarray(
                [
                    pose[0] + vel * dt * np.float32(np.cos(a)),
                    pose[1] + vel * dt * np.float32(np.sin(a)),
                    _wrap(pose[2] + vel * dt * np.float32(np.sin(swa)) / wb),
                ],
                np.float32,
            )
        xs[t] = pose
        swas[t] = swa
        actives[t] = not was_done
        dones[t] = done

    return TruthRollout(x_true=xs, swa=swas, active=actives, done=dones)


class ObsRollout(NamedTuple):
    z_true: np.ndarray   # (n_frames, NZ, 2) noiseless (range, bearing)
    ids: np.ndarray      # (n_frames, NZ) int32 landmark ids (-1 = empty slot)
    mask: np.ndarray     # (n_frames, NZ) bool slot validity


def rollout_observations(
    x_true: np.ndarray, landmarks: np.ndarray, max_range: float,
    nz: int, interval: int, use_native: bool = True,
) -> ObsRollout:
    """Noiseless sensor returns at each frame end, precomputed on the host.

    Mirrors sim.sensor_sim.get_observations + filters.common.compact in
    float32 (semicircular FoV, reference slam.h:644-648; ascending-id slot
    order): the device scan then consumes fixed-size (z, ids, mask) buffers
    and adds measurement noise — no per-frame visibility/compaction kernels
    on device.  Truth is deterministic, so this moves zero filter work.
    """
    if use_native:
        try:
            from conan_slam.native import rollout_observations_native

            z, ids, mask = rollout_observations_native(
                x_true, landmarks, max_range, nz, interval
            )
            return ObsRollout(z_true=z, ids=ids, mask=mask)
        except Exception:
            pass
    lm = np.asarray(landmarks, np.float32)                # (L, 2)
    poses = np.asarray(x_true, np.float32)[interval - 1 :: interval]  # (F, 3)
    n_frames = poses.shape[0]

    d = lm[None, :, :] - poses[:, None, :2]               # (F, L, 2)
    dx, dy = d[..., 0], d[..., 1]
    rng = np.sqrt(dx * dx + dy * dy, dtype=np.float32)
    brg = (
        np.arctan2(dy, dx).astype(np.float32)
        - poses[:, None, 2]
        + np.float32(np.pi)
    ) % np.float32(2 * np.pi) - np.float32(np.pi)
    in_box = np.logical_and(np.abs(dx) < max_range, np.abs(dy) < max_range)
    ahead = dx * np.cos(poses[:, None, 2]) + dy * np.sin(poses[:, None, 2]) > 0.0
    in_circle = dx * dx + dy * dy < np.float32(max_range) ** 2
    visible = in_box & ahead & in_circle                  # (F, L)

    z = np.zeros((n_frames, nz, 2), np.float32)
    ids = np.full((n_frames, nz), -1, np.int32)
    mask = np.zeros((n_frames, nz), bool)
    for f in range(n_frames):
        (vis_idx,) = np.nonzero(visible[f])
        vis_idx = vis_idx[:nz]
        k = vis_idx.shape[0]
        ids[f, :k] = vis_idx
        mask[f, :k] = True
        z[f, :k, 0] = rng[f, vis_idx]
        z[f, :k, 1] = brg[f, vis_idx]
    return ObsRollout(z_true=z, ids=ids, mask=mask)
