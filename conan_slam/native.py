"""ctypes bindings for the native host-side components.

``native/slam_baseline.cpp`` is the self-established CPU baseline
(BASELINE.md: the reference publishes no numbers) — a clean-room C++
EKF-SLAM running the exact reference workload.  The library auto-builds via
``make`` on first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libslam_baseline.so")
_HOSTSIM_PATH = os.path.join(_NATIVE_DIR, "build", "libhostsim.so")

_lib = None
_hostsim = None


def _stale(lib_path: str, *sources: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    lib_mtime = os.path.getmtime(lib_path)
    return any(
        os.path.exists(src) and os.path.getmtime(src) > lib_mtime
        for src in sources
    )


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # Rebuild when the source is newer than the .so — a stale build from an
    # earlier round lacks newer entry points (run_ekf_baseline_v3) and the
    # ctypes binding below would fail on it.
    if _stale(_LIB_PATH, os.path.join(_NATIVE_DIR, "slam_baseline.cpp")):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.run_ekf_baseline_v2.restype = ctypes.c_int64
    lib.run_ekf_baseline_v2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # landmarks
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # waypoints
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int,       # max_steps, seed, noise
        ctypes.c_int, ctypes.c_float,                      # prebuild_map, sigma0
        ctypes.c_int,                                      # opt (SIMD path)
        ctypes.POINTER(ctypes.c_double),                   # out seconds
        ctypes.POINTER(ctypes.c_float),                    # out ate
        ctypes.POINTER(ctypes.c_float),                    # out traj (nullable)
    ]
    lib.run_ekf_baseline_v3.restype = ctypes.c_int64
    lib.run_ekf_baseline_v3.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # landmarks
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,      # waypoints
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int,       # max_steps, seed, noise
        ctypes.c_int, ctypes.c_float,                      # prebuild_map, sigma0
        ctypes.c_int,                                      # opt (SIMD path)
        ctypes.c_int, ctypes.c_float, ctypes.c_float,      # gated, gate1, gate2
        ctypes.c_int,                                      # max_obs (0 = all)
        ctypes.POINTER(ctypes.c_double),                   # out seconds
        ctypes.POINTER(ctypes.c_float),                    # out ate
        ctypes.POINTER(ctypes.c_float),                    # out traj (nullable)
    ]
    _lib = lib
    return lib


def _load_hostsim():
    global _hostsim
    if _hostsim is not None:
        return _hostsim
    if _stale(_HOSTSIM_PATH, os.path.join(_NATIVE_DIR, "hostsim.cpp")):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(_HOSTSIM_PATH)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rollout_truth_native.restype = None
    lib.rollout_truth_native.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        f32p, f32p, u8p, u8p,
    ]
    lib.rollout_observations_native.restype = None
    lib.rollout_observations_native.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        f32p, i32p, u8p,
    ]
    _hostsim = lib
    return lib


def rollout_truth_native(waypoints: np.ndarray, cfg, n_steps: int):
    """Native truth rollout; see sim.precompute.rollout_truth for semantics.

    Returns (x_true (T,3) f32, swa (T,) f32, active (T,) bool, done (T,) bool).
    """
    lib = _load_hostsim()
    wp = np.ascontiguousarray(waypoints, dtype=np.float32)
    x_true = np.empty((n_steps, 3), np.float32)
    swa = np.empty((n_steps,), np.float32)
    active = np.empty((n_steps,), np.uint8)
    done = np.empty((n_steps,), np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rollout_truth_native(
        wp.ctypes.data_as(f32p), wp.shape[0], n_steps,
        np.float32(cfg.dt_controls), np.float32(cfg.velocity),
        np.float32(cfg.wheel_base),
        np.float32(cfg.rate_swa * cfg.dt_controls), np.float32(cfg.max_swa),
        np.float32(cfg.at_waypoint) ** 2, int(cfg.number_loops),
        x_true.ctypes.data_as(f32p), swa.ctypes.data_as(f32p),
        active.ctypes.data_as(u8p), done.ctypes.data_as(u8p),
    )
    return x_true, swa, active.astype(bool), done.astype(bool)


def rollout_observations_native(
    x_true: np.ndarray, landmarks: np.ndarray, max_range: float,
    nz: int, interval: int,
):
    """Native observation rollout; see sim.precompute.rollout_observations."""
    lib = _load_hostsim()
    xt = np.ascontiguousarray(x_true, dtype=np.float32)
    lm = np.ascontiguousarray(landmarks, dtype=np.float32)
    n_steps = xt.shape[0]
    n_frames = n_steps // interval
    z = np.empty((n_frames, nz, 2), np.float32)
    ids = np.empty((n_frames, nz), np.int32)
    mask = np.empty((n_frames, nz), np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rollout_observations_native(
        xt.ctypes.data_as(f32p), n_steps, interval,
        lm.ctypes.data_as(f32p), lm.shape[0], np.float32(max_range), nz,
        z.ctypes.data_as(f32p),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return z, ids, mask.astype(bool)


class BaselineResult(NamedTuple):
    steps: int
    seconds: float
    steps_per_s: float
    ate_rmse: float
    trajectory: np.ndarray | None


def run_ekf_baseline(
    landmarks: np.ndarray,
    waypoints: np.ndarray,
    max_steps: int = 25_000,
    seed: int = 0,
    with_noise: bool = True,
    want_trajectory: bool = False,
    prebuild_map: bool = False,
    sigma0: float = 1.0,
    opt: bool = False,
    gated: bool = False,
    gate_reject: float = 50.0,
    gate_augment: float = 1000.0,
    max_obs: int = 0,
) -> BaselineResult:
    """Run the native C++ EKF-SLAM on the given world (row-major (N, 2)).

    ``prebuild_map`` starts from a fully-registered map (steady-state
    tracking benchmark) instead of an empty one.  ``opt`` selects the
    SIMD-scheduled update path (the honest single-core CPU bound) instead of
    the reference-style scalar loops.  ``gated`` switches association from
    the ground-truth id table to defect-fixed Mahalanobis-gated NN
    (reference EKF.cpp:235-326 with SURVEY defect 4 fixed) with the given
    gates; ``max_obs`` caps the per-frame measurement buffer (0 = all
    visible) to mirror the JAX path's fixed-size compact buffer.
    """
    lib = _load()
    lm = np.ascontiguousarray(landmarks, dtype=np.float32)
    wp = np.ascontiguousarray(waypoints, dtype=np.float32)
    secs = ctypes.c_double(0.0)
    ate = ctypes.c_float(0.0)
    traj = np.zeros((max_steps, 3), np.float32) if want_trajectory else None
    traj_ptr = (
        traj.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if traj is not None
        else ctypes.POINTER(ctypes.c_float)()
    )
    steps = lib.run_ekf_baseline_v3(
        lm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lm.shape[0],
        wp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), wp.shape[0],
        max_steps, seed, int(with_noise), int(prebuild_map), sigma0,
        int(opt), int(gated), gate_reject, gate_augment, max_obs,
        ctypes.byref(secs), ctypes.byref(ate), traj_ptr,
    )
    secs_v = max(secs.value, 1e-9)
    return BaselineResult(
        steps=int(steps),
        seconds=secs_v,
        steps_per_s=steps / secs_v,
        ate_rmse=float(ate.value),
        trajectory=traj[:steps] if traj is not None else None,
    )
