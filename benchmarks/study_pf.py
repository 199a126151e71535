"""PF robustness study: seed-variance of FastSLAM 2.0 at the reference config.

The reference runs 100 particles (slam.h:92-93); round-1 notes recorded
0.2-6 m ATE seed variance there.  This study sweeps resampling kind and
roughening level over many seeds on the canonical valet world and reports
median / p90 ATE per configuration — the basis for the default knobs in
config.SlamConfig.

Run:        python benchmarks/study_pf.py [n_seeds] [n_steps]
On the CPU: JAX_PLATFORMS=cpu python benchmarks/study_pf.py 8 6000
Prints a markdown table on stdout; per-seed detail on stderr.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


CONFIGS = [
    # (label, resample kind, roughening, num_particles)
    ("reference (stratified, no roughening)", "stratified", 0.0, 100),
    ("systematic", "systematic", 0.0, 100),
    ("systematic + roughening 0.02", "systematic", 0.02, 100),
    ("systematic + roughening 0.05", "systematic", 0.05, 100),
    ("stratified + roughening 0.05", "stratified", 0.05, 100),
    # Particle-count scaling: the 2-seed probe showed per-seed failures are
    # insensitive to the resampling/roughening knobs (a bad seed fails under
    # every knob setting), pointing at ensemble size, not resampling bias.
    ("systematic, 400 particles", "systematic", 0.0, 400),
    ("systematic, 1000 particles", "systematic", 0.0, 1000),
]


def main():
    import jax

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from conan_slam.config import SlamConfig
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_pf_slam
    from conan_slam.sim.world import default_world

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 36
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 25_000
    world = default_world()
    log(f"devices: {jax.devices()}; seeds={n_seeds} steps={n_steps}")

    rows = []
    for label, kind, rough, n_part in CONFIGS:
        cfg = SlamConfig(
            num_particles=n_part, pf_resample_kind=kind, pf_roughening=rough
        )
        ates = []
        t0 = time.perf_counter()
        for s in range(n_seeds):
            carry, outs = run_pf_slam(world, cfg, jax.random.PRNGKey(s), n_steps=n_steps)
            ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
            ates.append(ate)
            log(f"  {label} seed {s}: ATE {ate:.3f} m")
        dt = time.perf_counter() - t0
        a = np.asarray(ates)
        rows.append((label, np.median(a), np.percentile(a, 90), a.max(),
                     float(np.mean(a > 1.0))))
        log(f"{label}: median {np.median(a):.3f} p90 {np.percentile(a, 90):.3f} "
            f"max {a.max():.3f} ({dt:.0f}s)")

    print(f"# PF robustness, {n_seeds} seeds x {n_steps} steps, "
          f"valet world, 100 particles (reference slam.h:92)")
    print("| configuration | median ATE [m] | p90 ATE [m] | max [m] | frac > 1 m |")
    print("|---|---|---|---|---|")
    for label, med, p90, amax, frac in rows:
        print(f"| {label} | {med:.3f} | {p90:.3f} | {amax:.3f} | {frac:.2f} |")


if __name__ == "__main__":
    main()
