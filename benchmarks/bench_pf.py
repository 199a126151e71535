"""Particle-filter throughput benchmark (BASELINE.json config 3).

Measures particle-steps/s for the vmapped FastSLAM 2.0 ensemble on the
canonical valet world over a sweep of ensemble sizes.  Run:
    python benchmarks/bench_pf.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(ensembles=(100, 1000, 10000, 100000)):
    import jax

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from conan_slam.config import SlamConfig
    from conan_slam.runner.loop import run_pf_slam
    from conan_slam.runner import metrics
    from conan_slam.sim.world import default_world

    world = default_world()
    steps = 1200
    log(f"devices: {jax.devices()}")
    results = {}
    for n_particles in ensembles:
        cfg = SlamConfig(num_particles=n_particles)
        t0 = time.time()
        carry, outs = run_pf_slam(world, cfg, jax.random.PRNGKey(0), n_steps=steps)
        jax.block_until_ready((carry, outs))
        log(f"N={n_particles}: compile+run {time.time() - t0:.1f}s")
        ts = []
        for i in range(3):
            t0 = time.perf_counter()
            carry, outs = run_pf_slam(
                world, cfg, jax.random.PRNGKey(i + 1), n_steps=steps
            )
            jax.block_until_ready((carry, outs))
            ts.append(time.perf_counter() - t0)
        best = min(ts)
        ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
        print(
            f"N={n_particles:6d}: {steps / best:8.0f} steps/s  "
            f"{n_particles * steps / best:12.3e} particle-steps/s  ATE={ate:.3f}",
            flush=True,
        )
        results[n_particles] = {
            "steps_per_s": round(steps / best, 1),
            "particle_steps_per_s": round(n_particles * steps / best, 1),
            "ate_m": round(ate, 4),
        }
    return results


if __name__ == "__main__":
    main()
