"""Headline-config ATE seed sweep: JAX filter vs native C++ on shared seeds.

A single-seed comparison of the headline bench (1024 pre-mapped
landmarks) says nothing about the distributions.  This sweeps N seeds of the SAME workload through both stacks.

Note the two stacks use different RNG streams (jax.random threefry vs
std::mt19937_64), so per-seed values differ by construction; the claim under
test is that the DISTRIBUTIONS overlap — i.e. the JAX filter is not
systematically less accurate than the reference-shaped C++ one.

Run: python benchmarks/seed_sweep.py [n_seeds]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(n_seeds: int = 20):
    import jax

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    import bench as bench_mod
    from conan_slam.config import SlamConfig
    from conan_slam.filters.ekf import init_state_with_map
    from conan_slam.native import run_ekf_baseline
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_ekf_slam_precomputed

    lm, wp, world = bench_mod.build_world()
    cfg = SlamConfig(max_landmarks=bench_mod.N_LANDMARKS, max_obs=64)
    state0 = init_state_with_map(world.landmarks, sigma0=bench_mod.SIGMA0)
    log(f"devices: {jax.devices()}")

    jax_ates, nat_ates = [], []
    for s in range(n_seeds):
        t0 = time.perf_counter()
        state, outs = run_ekf_slam_precomputed(
            world, cfg, jax.random.PRNGKey(s), n_steps=bench_mod.BENCH_STEPS,
            init_state=state0,
        )
        ate = float(metrics.ate_rmse(
            np.asarray(outs.x_est), np.asarray(outs.x_true)))
        jax_ates.append(ate)
        log(f"jax    seed {s}: ATE {ate:.4f} m ({time.perf_counter()-t0:.1f}s)")

    for s in range(n_seeds):
        res = run_ekf_baseline(
            lm, wp, bench_mod.BENCH_STEPS, seed=s, with_noise=True,
            prebuild_map=True, sigma0=bench_mod.SIGMA0, opt=True,
        )
        nat_ates.append(res.ate_rmse)
        log(f"native seed {s}: ATE {res.ate_rmse:.4f} m")

    t = np.asarray(jax_ates)
    n = np.asarray(nat_ates)
    print(f"# Headline-config ATE, {n_seeds} seeds x {bench_mod.BENCH_STEPS} "
          f"steps (1024 pre-mapped landmarks)")
    print("| stack | median | mean | p90 | max |")
    print("|---|---|---|---|---|")
    for name, a in (("JAX (threefry)", t), ("native C++ (mt19937)", n)):
        print(f"| {name} | {np.median(a):.4f} | {a.mean():.4f} | "
              f"{np.percentile(a, 90):.4f} | {a.max():.4f} |")
    # Mann-Whitney-ish rank check without scipy: fraction of cross pairs
    # where JAX < native (0.5 = identical distributions).
    wins = float(np.mean(t[:, None] < n[None, :]))
    print(f"# P(JAX seed beats native seed) = {wins:.3f} "
          f"(0.5 = indistinguishable)")
    print(f"# per-seed jax: {[round(x, 4) for x in jax_ates]}")
    print(f"# per-seed nat: {[round(x, 4) for x in nat_ates]}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
