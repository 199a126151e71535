"""Checkpoint/restore and loop-closure frontend tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_slam.filters import ekf
from conan_slam.graph.frontend import ClosureConfig, relax_trajectory
from conan_slam.graph.pose_graph import graph_error
from conan_slam.utils import checkpoint


def test_checkpoint_roundtrip_ekf_state(tmp_path):
    state = ekf.init_state(8, 12)
    state = state._replace(
        x=state.x.at[:3].set(jnp.asarray([1.0, 2.0, 0.3])),
        n_active=jnp.int32(5),
        table=state.table.at[2].set(4),
    )
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save(path, state)
    restored = checkpoint.restore(path, ekf.init_state(8, 12))
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_chunked_driver_kill_and_resume_bit_identical(tmp_path):
    """Kill-and-resume oracle for the checkpointing chunked driver: a run
    interrupted after chunk k (simulated by a shortened-horizon run that
    leaves its checkpoints behind) and then resumed over the full horizon
    must produce the SAME final state and trajectory as an uninterrupted
    run — bit-identical, because chunk boundaries and per-chunk noise keys
    are deterministic in the arguments."""
    from conan_slam.config import SlamConfig
    from conan_slam.runner.loop import (
        precompute_rollout,
        run_ekf_slam_precomputed_chunked,
    )
    from conan_slam.sim.world import default_world

    world = default_world()
    cfg = SlamConfig(max_landmarks=30)
    key = jax.random.PRNGKey(7)
    n_steps, chunk = 1200, 300
    roll = precompute_rollout(world, cfg, n_steps)

    # Uninterrupted reference (no checkpointing).
    state_ref, outs_ref = run_ekf_slam_precomputed_chunked(
        world, cfg, key, n_steps, chunk, precomputed=roll
    )

    # "Killed" run: two chunks complete, checkpoints written, process gone.
    ckpt_dir = os.path.join(tmp_path, "run")
    run_ekf_slam_precomputed_chunked(
        world, cfg, key, 2 * chunk, chunk, precomputed=roll,
        checkpoint_dir=ckpt_dir,
    )
    assert os.path.isdir(os.path.join(ckpt_dir, "chunk_00001"))

    # Resume over the full horizon from the surviving checkpoints.
    state_res, outs_res = run_ekf_slam_precomputed_chunked(
        world, cfg, key, n_steps, chunk, precomputed=roll,
        checkpoint_dir=ckpt_dir,
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(state_res), jax.tree_util.tree_leaves(state_ref)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree_util.tree_leaves(outs_res), jax.tree_util.tree_leaves(outs_ref)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plot_run_writes_png_with_covariance_ellipses(tmp_path):
    """Viz smoke test over the canonical run: plot_run with the joint
    covariance draws pose + per-feature ellipses and writes a PNG
    (the capability the reference lacks, reference README.md:14-21)."""
    pytest.importorskip("matplotlib")
    from conan_slam.config import SlamConfig
    from conan_slam.runner.loop import run_ekf_slam
    from conan_slam.sim.world import default_world
    from conan_slam.utils.viz import plot_run

    world = default_world()
    carry, outs = run_ekf_slam(
        world, SlamConfig(), jax.random.PRNGKey(0), n_steps=600
    )
    png = os.path.join(tmp_path, "run.png")
    fig = plot_run(
        outs.x_true, outs.x_est,
        landmarks=world.landmarks,
        features=carry.state.features,
        active_mask=np.arange(carry.state.capacity) < int(carry.state.n_active),
        valid=~np.asarray(outs.done),
        p=carry.state.p,
        save_path=png,
    )
    assert os.path.isfile(png) and os.path.getsize(png) > 10_000
    # Ellipse artists present: pose ellipse + >=1 feature ellipse lines.
    labels = [ln.get_label() for ln in fig.axes[0].get_lines()]
    assert any("sigma (pose)" in str(l) for l in labels), labels
    assert any("sigma (features)" in str(l) for l in labels), labels


def test_frontend_relaxes_drifting_trajectory():
    # Synthetic figure: truth goes around a loop; estimate drifts linearly.
    t = 800
    ang = np.linspace(0, 2 * np.pi, t).astype(np.float32)
    truth = np.stack(
        [200 * np.sin(ang), 200 * (1 - np.cos(ang)), ang + np.pi / 2], axis=1
    ).astype(np.float32)
    drift = np.linspace(0, 1, t)[:, None] * np.asarray([[15.0, -10.0, 0.0]])
    est = (truth + drift).astype(np.float32)
    valid = np.ones((t,), bool)

    cfg = ClosureConfig(keyframe_stride=20, radius=60.0, min_index_gap=10)
    g, g_opt = relax_trajectory(
        jnp.asarray(est), jnp.asarray(truth), jnp.asarray(valid), cfg,
        jax.random.PRNGKey(0), iterations=10, cg_iterations=60,
    )
    assert float(graph_error(g_opt)) < float(graph_error(g))
    # End-of-loop error vs truth should shrink substantially after relaxation.
    err_before = np.linalg.norm(est[::20][-1, :2] - truth[::20][-1, :2])
    err_after = np.linalg.norm(
        np.asarray(g_opt.nodes)[-1, :2] - truth[::20][-1, :2]
    )
    assert err_after < 0.5 * err_before, (err_before, err_after)
