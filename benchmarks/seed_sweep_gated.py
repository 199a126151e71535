"""Config-2 (gated-NN, 500 landmarks, mapping from scratch) ATE seed sweep:
JAX filter vs the defect-fixed native C++ gated baseline on the SAME world.

The gated configs' ATE claims need an independent same-workload CPU anchor
the way the headline has one (the reference's own
gated path is defect-broken — EKF.cpp:308/311, SURVEY section 8.4 — so the
oracle is the defect-FIXED algorithm, implemented independently in
native/slam_baseline.cpp::associate_gated and filters/ekf/associate.py).

As in seed_sweep.py, the two stacks use different RNG streams, so the claim
under test is distributional: JAX gated-NN mapping from scratch is not
systematically less accurate than the same algorithm in straightforward C++.

Run: python benchmarks/seed_sweep_gated.py [n_seeds]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_LANDMARKS = int(os.environ.get("GATED_LANDMARKS", "500"))
WORLD_SEED = 7          # bench_gated.py's world
STEPS = int(os.environ.get("GATED_STEPS", "25000"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(n_seeds: int = 12):
    import jax

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from conan_slam.config import SlamConfig
    from conan_slam.native import run_ekf_baseline
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import (
        precompute_rollout,
        run_ekf_slam_precomputed,
    )
    from conan_slam.sim.world import default_world, random_world

    world = random_world(jax.random.PRNGKey(WORLD_SEED), N_LANDMARKS)._replace(
        waypoints=default_world().waypoints
    )
    cfg = SlamConfig(
        max_landmarks=N_LANDMARKS, max_obs=64,
        switch_association_known=False,
    )
    roll = precompute_rollout(world, cfg, STEPS)
    log(f"devices: {jax.devices()}")

    jx, nat = [], []
    for s in range(n_seeds):
        t0 = time.perf_counter()
        state, outs = run_ekf_slam_precomputed(
            world, cfg, jax.random.PRNGKey(s), n_steps=STEPS, precomputed=roll
        )
        ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
        jx.append(ate)
        log(f"jax    seed {s}: ATE {ate:.4f} m, mapped {int(state.n_active)} "
            f"({time.perf_counter()-t0:.1f}s)")

    lm = np.asarray(world.landmarks)
    wp = np.asarray(world.waypoints)
    for s in range(n_seeds):
        t0 = time.perf_counter()
        res = run_ekf_baseline(
            lm, wp, STEPS, seed=s, with_noise=True, opt=True,
            gated=True, gate_reject=cfg.gate_reject,
            gate_augment=cfg.gate_augment, max_obs=cfg.max_obs,
        )
        nat.append(res.ate_rmse)
        log(f"native seed {s}: ATE {res.ate_rmse:.4f} m "
            f"({time.perf_counter()-t0:.1f}s, {res.steps_per_s:,.0f} steps/s)")

    t = np.asarray(jx)
    n = np.asarray(nat)
    print(f"# Config-2 gated-NN ATE, {n_seeds} seeds x {STEPS} steps "
          f"({N_LANDMARKS} landmarks, mapping from scratch)")
    print("| stack | median | mean | p90 | max |")
    print("|---|---|---|---|---|")
    for name, a in (("JAX gated (threefry)", t),
                    ("native C++ gated (mt19937)", n)):
        print(f"| {name} | {np.median(a):.4f} | {a.mean():.4f} | "
              f"{np.percentile(a, 90):.4f} | {a.max():.4f} |")
    wins = float(np.mean(t[:, None] < n[None, :]))
    print(f"# P(JAX seed beats native seed) = {wins:.3f} "
          f"(0.5 = indistinguishable)")
    print(f"# per-seed jax: {[round(x, 4) for x in jx]}")
    print(f"# per-seed nat: {[round(x, 4) for x in nat]}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12)
