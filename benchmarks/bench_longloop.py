"""BASELINE.json config 4: long valet tour, 5k landmarks, loop closure +
pose-graph relaxation.

Two stages:
  1. FILTER: the vehicle drives a star-polygon tour (the path self-intersects
     repeatedly — a multi-loop facility sweep) through a 5,000-landmark world
     (joint state D = 10,003 -> padded 10,240; dense P ~420 MB on the device),
     mapping from scratch.  Reports control steps/s at the largest
     single-chip state size.
  2. POSE GRAPH: the classic loop-closure regime on the same tour — a
     dead-reckoned keyframe odometry chain (sensor-outage segments) with
     simulated scan-match closures at the tour's transverse self-crossings,
     relaxed by chordal initialisation + Gauss-Newton (graph.pose_graph).
     Reports aligned keyframe ATE before/after relaxation.

Run: python benchmarks/bench_longloop.py [--steps N] [--landmarks N]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


N_LANDMARKS = 5000
SEED = 11


def star_waypoints(radius: float = 4000.0) -> np.ndarray:
    """8-point star-polygon tour from the origin: many transverse
    self-crossings (the geometry loop closure needs)."""
    ang = np.arange(8) * 2 * np.pi / 8
    pts = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    order = [(3 * i) % 8 for i in range(8)] + [0]
    return np.concatenate([np.zeros((1, 2)), pts[order]]).astype(np.float32)


def main(steps: int = 56_000, landmarks: int = N_LANDMARKS):
    import types

    args = types.SimpleNamespace(steps=steps, landmarks=landmarks)

    import jax
    import jax.numpy as jnp

    from conan_slam.config import SlamConfig
    from conan_slam.graph import pose_graph as pg
    from conan_slam.graph.frontend import ClosureConfig, simulate_odometry_graph
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_ekf_slam_precomputed
    from conan_slam.sim.world import World, random_world

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    n_lm = args.landmarks
    world = random_world(jax.random.PRNGKey(SEED), n_lm)
    world = world._replace(waypoints=jnp.asarray(star_waypoints()))

    # Stage 1 runs the reference-faithful anchored config (an EKF with NO
    # heading anchor diverges over a 56k-step tour — exactly the failure mode
    # stage 2's pose-graph pipeline exists to handle).
    cfg = SlamConfig(max_landmarks=n_lm, max_obs=64)
    log(f"devices: {jax.devices()}; D={3 + 2 * n_lm} "
        f"(P ~{(3 + 2 * n_lm)**2 * 4 / 2**30:.2f} GiB unpadded)")

    # --- stage 1: filter throughput at max single-chip state size ---
    t0 = time.time()
    state, outs = run_ekf_slam_precomputed(
        world, cfg, jax.random.PRNGKey(0), n_steps=args.steps
    )
    jax.block_until_ready((state, outs))
    log(f"compile+first run: {time.time() - t0:.1f}s")

    t0 = time.perf_counter()
    state, outs = run_ekf_slam_precomputed(
        world, cfg, jax.random.PRNGKey(1), n_steps=args.steps
    )
    jax.block_until_ready((state, outs))
    wall = time.perf_counter() - t0
    ate_filter = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))

    # --- stage 2: dead-reckoned chain + closures + relaxation ---
    truth = jnp.asarray(outs.x_true)
    valid = jnp.asarray(~np.asarray(outs.done))
    # Round-5 settings after a CPU sensitivity sweep (radius 100-300, gap
    # 20-60, max_closures 256-2048, closure sigma down to 0.01 m, GN/CG
    # budgets up to 50 x 4N): the relaxed aligned ATE saturates at ~31 m
    # with iterations=50 / cg=4N (from 37.6 at the round-4 budget).  The
    # residual is STRUCTURAL, not convergence or detection: closures exist
    # only near the star tour's self-crossings, and between crossings the
    # arc interiors are constrained only by the odometry random walk
    # (sigma_th 0.01 rad/keyframe over ~140-keyframe arcs) — near-exact
    # closures (sigma 0.01 m) and 9x denser closures both FAIL to beat it
    # (the denser/stiffer graphs actually converge WORSE under block-Jacobi
    # CG — a preconditioning limit recorded for future work).
    ccfg = ClosureConfig(odo_sigma_xy=0.5, odo_sigma_th=0.01,
                         max_closures=256, min_index_gap=60)
    t0 = time.perf_counter()
    g = simulate_odometry_graph(truth, valid, ccfg, jax.random.PRNGKey(2))
    g_opt = pg.optimize(
        g, iterations=50, cg_iterations=4 * g.nodes.shape[0],
        chordal_init=True,
    )
    jax.block_until_ready(g_opt)
    relax_wall = time.perf_counter() - t0

    stride = ccfg.keyframe_stride
    kf_true = truth[::stride][: g.nodes.shape[0]]
    kf_valid = valid[::stride][: g.nodes.shape[0]]

    def ate(nodes):
        return float(metrics.aligned_ate_rmse(kf_true, nodes, kf_valid))

    n_closures = int(np.asarray(g.edge_mask)[g.nodes.shape[0] - 1:].sum())
    print(
        f"longloop {n_lm}lm star tour: filter {args.steps / wall:,.0f} steps/s "
        f"({wall:.2f}s), mapped={int(state.n_active)}, "
        f"filter ATE={ate_filter:.2f} m; "
        f"pose-graph: {n_closures} closures, dead-reckoned alignedATE "
        f"{ate(g.nodes):.1f} -> {ate(g_opt.nodes):.1f} m "
        f"(chi2 {float(pg.graph_error(g)):.0f} -> "
        f"{float(pg.graph_error(g_opt)):.0f}, {relax_wall:.1f}s)",
        flush=True,
    )
    return {
        "filter_steps_per_s": round(args.steps / wall, 1),
        "filter_ate_m": round(ate_filter, 3),
        "mapped": int(state.n_active),
        "closures": n_closures,
        "aligned_ate_dead_reckoned_m": round(ate(g.nodes), 2),
        "aligned_ate_relaxed_m": round(ate(g_opt.nodes), 2),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=56_000)
    ap.add_argument("--landmarks", type=int, default=N_LANDMARKS)
    a = ap.parse_args()
    main(steps=a.steps, landmarks=a.landmarks)
