"""Diagnostic: how much does pose-graph relaxation improve a drifted
no-heading run?  Sweeps ClosureConfig stiffness on one filter trajectory.

Run: python benchmarks/probe_closure.py [--landmarks N] [--steps N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--landmarks", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=28_000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from conan_slam.config import SlamConfig
    from conan_slam.graph.frontend import ClosureConfig, relax_trajectory
    from conan_slam.graph.pose_graph import graph_error
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_ekf_slam_precomputed
    from conan_slam.sim.world import default_world, random_world

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    world = random_world(jax.random.PRNGKey(11), args.landmarks)
    wp = jnp.concatenate([default_world().waypoints, jnp.zeros((1, 2), jnp.float32)])
    world = world._replace(waypoints=wp)
    cfg = SlamConfig(max_landmarks=args.landmarks, max_obs=64,
                     switch_heading_known=False)
    state, outs = run_ekf_slam_precomputed(
        world, cfg, jax.random.PRNGKey(1), n_steps=args.steps
    )
    est = np.asarray(outs.x_est)
    true = np.asarray(outs.x_true)
    valid = ~np.asarray(outs.done)
    print(f"full ATE raw: {float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done)):.2f} m",
          flush=True)

    for tag, ccfg in [
        ("default", ClosureConfig()),
        ("loose-odo", ClosureConfig(odo_sigma_xy=5.0, odo_sigma_th=0.1)),
        ("tight-closure", ClosureConfig(closure_sigma_xy=0.1, closure_sigma_th=0.002)),
        ("more-closures", ClosureConfig(max_closures=256, radius=300.0)),
        ("loose+more", ClosureConfig(odo_sigma_xy=5.0, odo_sigma_th=0.1,
                                     max_closures=256, radius=300.0)),
    ]:
        import os
        iters = int(os.environ.get("PG_ITERS", "10"))
        cg = int(os.environ.get("PG_CG", "50"))
        g, g_opt = relax_trajectory(est, true, valid, ccfg, jax.random.PRNGKey(2),
                                    iterations=iters, cg_iterations=cg)
        stride = ccfg.keyframe_stride
        nodes0 = np.asarray(g.nodes)
        nodes1 = np.asarray(g_opt.nodes)
        nmask = np.asarray(g_opt.node_mask)
        kf_truth = true[::stride][: nodes1.shape[0]]
        kf_valid = valid[::stride][: nodes1.shape[0]] & nmask
        import jax.numpy as jnp

        def kf_ate(nodes):
            return float(metrics.aligned_ate_rmse(
                jnp.asarray(kf_truth), jnp.asarray(nodes[: kf_truth.shape[0]]),
                jnp.asarray(kf_valid),
            ))
        ncl = int(np.asarray(g.edge_mask).sum()) - int(nmask.sum() - 1)
        print(f"{tag:14s}: closures={ncl:4d} alignedkfATE {kf_ate(nodes0):7.2f} -> "
              f"{kf_ate(nodes1):7.2f} m, chi2 {float(graph_error(g)):9.1f} -> "
              f"{float(graph_error(g_opt)):9.1f}", flush=True)


if __name__ == "__main__":
    main()
