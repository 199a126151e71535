"""BASELINE.json config 2: EKF-SLAM, 500 landmarks, full joint covariance,
Mahalanobis-gated NN association, mapping from scratch.

The vehicle drives the canonical valet waypoint tour through a 500-landmark
world with an EMPTY initial map and unknown correspondences: every frame runs
dense masked gating (virtual-covariance NIS against all slots), the fused
single-P-rewrite measurement update, and masked augmentation as new landmarks
are discovered.  Reports control steps/s, ATE RMSE, and the mapped count.

Run: python benchmarks/bench_gated.py [steps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def log(*a):
    print(*a, file=sys.stderr, flush=True)


N_LANDMARKS = int(os.environ.get("GATED_LANDMARKS", "500"))
SEED = 7


def main(steps: int = 25_000):
    import jax

    from conan_slam.config import SlamConfig
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_ekf_slam_precomputed
    from conan_slam.sim.world import default_world, random_world

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    # 500 random landmarks, canonical waypoint tour (comparable trajectory).
    wworld = random_world(jax.random.PRNGKey(SEED), N_LANDMARKS)
    world = wworld._replace(waypoints=default_world().waypoints)

    cfg = SlamConfig(
        max_landmarks=N_LANDMARKS,
        max_obs=64,
        switch_association_known=False,   # gated NN (the config-2 regime)
    )
    from conan_slam.runner.loop import (
        precompute_rollout,
        run_ekf_slam_precomputed_chunked,
    )

    # GATED_CHUNK splits the horizon into same-shape dispatches (large-D
    # frames run ms each; chunks let the host checkpoint and report between
    # them).
    chunk = int(os.environ.get("GATED_CHUNK", "0"))
    # GATED_CKPT_DIR turns on per-chunk checkpoint/resume (utils.checkpoint
    # via the chunked driver) — a killed run restarted with the same env
    # resumes from the last complete chunk bit-identically.
    ckpt_dir = os.environ.get("GATED_CKPT_DIR") or None
    roll = precompute_rollout(world, cfg, steps)   # seed-independent workload

    log(f"devices: {jax.devices()}")
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    if chunk:
        state, outs = run_ekf_slam_precomputed_chunked(
            world, cfg, key, n_steps=steps, chunk_steps=chunk,
            precomputed=roll, checkpoint_dir=ckpt_dir,
        )
    else:
        state, outs = run_ekf_slam_precomputed(
            world, cfg, key, n_steps=steps, precomputed=roll
        )
    jax.block_until_ready((state, outs))
    log(f"compile+first run: {time.time() - t0:.1f}s")
    ts = []
    for i in range(3):
        t0 = time.perf_counter()
        if chunk:
            state, outs = run_ekf_slam_precomputed_chunked(
                world, cfg, jax.random.PRNGKey(100 + i), n_steps=steps,
                chunk_steps=chunk, precomputed=roll,
            )
        else:
            state, outs = run_ekf_slam_precomputed(
                world, cfg, jax.random.PRNGKey(100 + i), n_steps=steps,
                precomputed=roll,
            )
        jax.block_until_ready((state, outs))
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
    print(
        f"gated {N_LANDMARKS}lm from scratch: {steps / best:,.0f} steps/s, "
        f"ATE={ate:.3f} m, mapped={int(state.n_active)}",
        flush=True,
    )
    return {
        "steps_per_s": round(steps / best, 1),
        "ate_m": round(ate, 4),
        "mapped": int(state.n_active),
        "landmarks": N_LANDMARKS,
    }


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 25_000)
