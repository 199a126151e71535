"""Loop-closure front end: keyframes, closure constraints, graph assembly.

Ties the filter trajectory to the pose-graph backend (BASELINE.json config 4).
No reference analogue — the reference never corrects past poses.

Pipeline (all static-shape, jittable):
  1. keyframes: stride-subsample the estimated trajectory;
  2. odometry edges: relative pose between consecutive keyframe estimates
     (what the filter believed it travelled);
  3. closure edges: revisit candidates from ``detect_loop_closures`` with a
     simulated scan-match measurement (true relative pose + matcher noise —
     the sim stands in for a real place-recognition/registration stack);
  4. relax with ``optimize``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.graph.pose_graph import (
    PoseGraph,
    detect_loop_closures,
    optimize,
    relative_pose,
)


class ClosureConfig(NamedTuple):
    keyframe_stride: int = 50        # control steps between keyframes
    max_closures: int = 64
    radius: float = 100.0            # revisit radius [m]
    min_index_gap: int = 40          # keyframes apart to count as revisit
    # Edge information: odometry-edge uncertainty must reflect the filter's
    # actual drift growth per keyframe interval (over-weighting odometry makes
    # the chain too stiff for closures to correct).
    odo_sigma_xy: float = 1.0        # odometry edge noise [m]
    odo_sigma_th: float = 0.02      # [rad]
    closure_sigma_xy: float = 0.5    # simulated scan-match noise [m]
    closure_sigma_th: float = 0.01  # [rad]


def build_graph(
    est_traj,
    true_traj,
    valid,
    cfg: ClosureConfig,
    key,
    det_nodes=None,
    init_nodes=None,
) -> PoseGraph:
    """Assemble a pose graph from a (T, 3) trajectory.

    ``est_traj`` provides node initial values and odometry edges;
    ``true_traj`` + noise provides closure measurements (simulated matcher).
    ``valid`` masks post-termination steps.

    ``det_nodes`` (optional, keyframe-rate (T', 3)) overrides the positions
    used for REVISIT DETECTION — pass the previous round's relaxed nodes
    for the realistic iterated pipeline (place recognition against the
    current estimate instead of the ground-truth oracle).  ``init_nodes``
    similarly overrides the node initial values."""
    stride = cfg.keyframe_stride
    kf_est = est_traj[::stride]
    kf_true = true_traj[::stride]
    kf_valid = valid[::stride]
    t = kf_est.shape[0]
    if init_nodes is not None:
        kf_est = init_nodes

    # Odometry edges between consecutive keyframes.
    e_odo = jnp.stack(
        [jnp.arange(t - 1, dtype=jnp.int32), jnp.arange(1, t, dtype=jnp.int32)],
        axis=1,
    )
    odo_meas = relative_pose(kf_est[:-1], kf_est[1:])
    odo_mask = jnp.logical_and(kf_valid[:-1], kf_valid[1:])
    w_odo = jnp.asarray(
        [1.0 / cfg.odo_sigma_xy**2, 1.0 / cfg.odo_sigma_xy**2, 1.0 / cfg.odo_sigma_th**2],
        jnp.float32,
    )
    odo_info = jnp.tile(jnp.diag(w_odo)[None], (t - 1, 1, 1))

    # Closure edges from revisit detection.  Default: the *true* keyframe
    # positions — place recognition sees the actual world (appearance), not
    # the drifted estimate, so detecting on the estimate would hide exactly
    # the revisits that matter (large-drift returns to a known place).
    # ``det_nodes`` switches to estimate-based detection for the realistic
    # iterated pipeline (relax_trajectory rounds > 1): each relaxation pulls
    # the estimate closer to truth, so re-detection recovers closures the
    # drifted initial estimate missed.  The MEASUREMENT is always the
    # simulated scan-match (true relative pose + matcher noise).
    pairs, pair_mask = detect_loop_closures(
        kf_true if det_nodes is None else det_nodes,
        kf_valid,
        max_candidates=cfg.max_closures,
        radius=cfg.radius,
        min_index_gap=cfg.min_index_gap,
    )
    safe_pairs = jnp.clip(pairs, 0, t - 1)
    cl_true = relative_pose(kf_true[safe_pairs[:, 0]], kf_true[safe_pairs[:, 1]])
    noise = jax.random.normal(key, cl_true.shape, dtype=cl_true.dtype) * jnp.asarray(
        [cfg.closure_sigma_xy, cfg.closure_sigma_xy, cfg.closure_sigma_th]
    )
    cl_meas = cl_true + noise
    w_cl = jnp.asarray(
        [
            1.0 / cfg.closure_sigma_xy**2,
            1.0 / cfg.closure_sigma_xy**2,
            1.0 / cfg.closure_sigma_th**2,
        ],
        jnp.float32,
    )
    cl_info = jnp.tile(jnp.diag(w_cl)[None], (pairs.shape[0], 1, 1))

    return PoseGraph(
        nodes=kf_est,
        node_mask=kf_valid,
        edges=jnp.concatenate([e_odo, safe_pairs]),
        meas=jnp.concatenate([odo_meas, cl_meas]),
        info=jnp.concatenate([odo_info, cl_info]),
        edge_mask=jnp.concatenate([odo_mask, pair_mask]),
    )


def compose_pose(pose, rel):
    """SE(2) composition: pose ⊕ rel (both (..., 3))."""
    c = jnp.cos(pose[..., 2])
    s = jnp.sin(pose[..., 2])
    from conan_slam.core.geometry import wrap_angle

    return jnp.stack(
        [
            pose[..., 0] + c * rel[..., 0] - s * rel[..., 1],
            pose[..., 1] + s * rel[..., 0] + c * rel[..., 1],
            wrap_angle(pose[..., 2] + rel[..., 2]),
        ],
        axis=-1,
    )


def simulate_odometry_graph(
    true_traj,
    valid,
    cfg: ClosureConfig,
    key,
) -> PoseGraph:
    """Dead-reckoned odometry chain + simulated closures on a true trajectory.

    The classic pose-graph regime (BASELINE config 4): between closures the
    only information is noisy relative odometry — heading noise random-walks
    and the integrated chain drifts without bound; revisit closures
    (place recognition on the true positions + scan-match noise) constrain
    the shape and relaxation recovers it.  This models long valet segments
    where landmark SLAM is unavailable (sensor outage / featureless areas),
    complementary to the EKF/PF filters.
    """
    stride = cfg.keyframe_stride
    kf_true = true_traj[::stride]
    kf_valid = valid[::stride]
    t = kf_true.shape[0]
    k_odo, k_cl = jax.random.split(key)

    rel_true = relative_pose(kf_true[:-1], kf_true[1:])
    sig = jnp.asarray([cfg.odo_sigma_xy, cfg.odo_sigma_xy, cfg.odo_sigma_th])
    rel_noisy = rel_true + sig * jax.random.normal(
        k_odo, rel_true.shape, rel_true.dtype
    )

    # Integrate the noisy chain (the dead-reckoned node initialisation).
    def step(pose, rel):
        nxt = compose_pose(pose, rel)
        return nxt, nxt

    _, chain = jax.lax.scan(step, kf_true[0], rel_noisy)
    nodes = jnp.concatenate([kf_true[:1], chain], axis=0)

    e_odo = jnp.stack(
        [jnp.arange(t - 1, dtype=jnp.int32), jnp.arange(1, t, dtype=jnp.int32)],
        axis=1,
    )
    odo_mask = jnp.logical_and(kf_valid[:-1], kf_valid[1:])
    w_odo = jnp.asarray(
        [1.0 / cfg.odo_sigma_xy**2, 1.0 / cfg.odo_sigma_xy**2,
         1.0 / cfg.odo_sigma_th**2],
        jnp.float32,
    )
    odo_info = jnp.tile(jnp.diag(w_odo)[None], (t - 1, 1, 1))

    pairs, pair_mask = detect_loop_closures(
        kf_true, kf_valid, max_candidates=cfg.max_closures,
        radius=cfg.radius, min_index_gap=cfg.min_index_gap,
    )
    safe_pairs = jnp.clip(pairs, 0, t - 1)
    cl_true = relative_pose(kf_true[safe_pairs[:, 0]], kf_true[safe_pairs[:, 1]])
    cl_meas = cl_true + jax.random.normal(
        k_cl, cl_true.shape, cl_true.dtype
    ) * jnp.asarray([cfg.closure_sigma_xy, cfg.closure_sigma_xy, cfg.closure_sigma_th])
    w_cl = jnp.asarray(
        [1.0 / cfg.closure_sigma_xy**2, 1.0 / cfg.closure_sigma_xy**2,
         1.0 / cfg.closure_sigma_th**2],
        jnp.float32,
    )
    cl_info = jnp.tile(jnp.diag(w_cl)[None], (pairs.shape[0], 1, 1))

    return PoseGraph(
        nodes=nodes,
        node_mask=kf_valid,
        edges=jnp.concatenate([e_odo, safe_pairs]),
        meas=jnp.concatenate([rel_noisy, cl_meas]),
        info=jnp.concatenate([odo_info, cl_info]),
        edge_mask=jnp.concatenate([odo_mask, pair_mask]),
    )


def relax_trajectory(
    est_traj,
    true_traj,
    valid,
    cfg: ClosureConfig,
    key,
    *,
    iterations: int = 10,
    cg_iterations: int | None = None,
    rounds: int = 1,
    detect_on_estimate: bool = False,
):
    """Build + optimise the pose graph; returns (graph, optimised graph).

    ``cg_iterations`` defaults to the keyframe count: corrections propagate
    roughly one node per CG iteration along the odometry chain, so the
    iteration budget must scale with the graph (block-Jacobi preconditioning
    in ``optimize`` handles the metre/radian unit heterogeneity).

    ``rounds`` > 1 iterates DETECT -> RELAX: each round re-detects closures
    and re-optimises from the previous round's relaxed nodes.  With
    ``detect_on_estimate=True`` detection runs against the current estimate
    (the realistic no-oracle pipeline) — round 1 only finds revisits where
    the drifted estimate happens to be near-correct; relaxation pulls the
    trajectory toward truth, so later rounds recover progressively more
    closures.  With oracle (truth-based) detection extra rounds only
    re-linearise, which ``iterations`` already covers."""
    det = (
        est_traj[:: cfg.keyframe_stride] if detect_on_estimate else None
    )
    g_opt = None
    for r in range(max(1, rounds)):
        g = build_graph(
            est_traj, true_traj, valid, cfg, jax.random.fold_in(key, r),
            det_nodes=det,
            init_nodes=None if g_opt is None else g_opt.nodes,
        )
        if cg_iterations is None:
            cg_iterations = max(60, g.nodes.shape[0])
        g_opt = optimize(
            g, iterations=iterations, cg_iterations=cg_iterations,
            chordal_init=(g_opt is None),
        )
        if detect_on_estimate:
            det = g_opt.nodes
        elif rounds > 1 and r == 0:
            # Oracle detection is round-invariant; nothing more to find.
            break
    return g, g_opt
