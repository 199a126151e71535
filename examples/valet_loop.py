"""Example: run the canonical valet-parking loop with both estimators.

Usage:
    python examples/valet_loop.py [--pf] [--gated] [--no-heading] [--steps N]

Runs on whatever JAX backend is active (the GPU where there is one; set
JAX_PLATFORMS=cpu to run on the CPU).
"""

import argparse
import os
import sys
import time

import numpy as np

# Runnable as `python examples/valet_loop.py` without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pf", action="store_true", help="run FastSLAM 2.0 instead of EKF")
    ap.add_argument("--gated", action="store_true", help="gated NN association (EKF)")
    ap.add_argument("--no-heading", action="store_true", help="disable heading observation")
    ap.add_argument("--steps", type=int, default=25_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop-closure", action="store_true",
                    help="relax the trajectory with the pose-graph backend")
    args = ap.parse_args()

    import jax

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from conan_slam.config import SlamConfig
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_ekf_slam, run_pf_slam
    from conan_slam.sim.world import default_world

    cfg = SlamConfig(
        switch_association_known=not args.gated,
        switch_heading_known=not args.no_heading,
    )
    world = default_world()
    run = run_pf_slam if args.pf else run_ekf_slam

    t0 = time.time()
    carry, outs = run(world, cfg, jax.random.PRNGKey(args.seed), n_steps=args.steps)
    jax.block_until_ready((carry, outs))
    wall = time.time() - t0

    valid = ~np.asarray(outs.done)
    ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
    done_at = int(np.asarray(outs.done).argmax()) if np.asarray(outs.done).any() else args.steps
    n_map = int(carry.state.n_active if not args.pf else carry.ens.n_active)
    print(f"estimator      : {'FastSLAM 2.0' if args.pf else 'EKF-SLAM'}")
    print(f"course complete: step {done_at} / {args.steps}")
    print(f"ATE RMSE       : {ate:.3f} m")
    print(f"mapped features: {n_map} / {world.num_landmarks}")
    print(f"wall (incl jit): {wall:.1f} s")

    if args.loop_closure:
        from conan_slam.graph.frontend import ClosureConfig, relax_trajectory
        from conan_slam.graph.pose_graph import graph_error

        g, g_opt = relax_trajectory(
            outs.x_est, outs.x_true, ~outs.done, ClosureConfig(),
            jax.random.PRNGKey(1),
        )
        print(f"pose graph     : chi2 {float(graph_error(g)):.1f} -> "
              f"{float(graph_error(g_opt)):.1f}")


if __name__ == "__main__":
    main()
