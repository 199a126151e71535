"""Simulation-layer tests: host truth rollout vs the on-device chain."""

import jax
import jax.numpy as jnp
import numpy as np

from conan_slam.config import SlamConfig
from conan_slam.runner.loop import _advance_truth
from conan_slam.sim.precompute import rollout_truth
from conan_slam.sim.steering import init_steer_state
from conan_slam.sim.world import default_world


def test_rollout_matches_device_truth_chain():
    world = default_world()
    cfg = SlamConfig(switch_control_noise=False)
    n = 4000

    roll = rollout_truth(np.asarray(world.waypoints), cfg, n)

    def step(carry, _):
        st, x_true = carry
        st, x_true, vn, swan = _advance_truth(
            st, x_true, world, cfg, jax.random.PRNGKey(0)
        )
        return (st, x_true), (x_true, st.swa, st.done)

    (_, _), (xs, swas, dones) = jax.lax.scan(
        step, (init_steer_state(cfg.number_loops), jnp.zeros(3, jnp.float32)),
        None, length=n,
    )
    np.testing.assert_allclose(np.asarray(xs), roll.x_true, rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(np.asarray(swas), roll.swa, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(dones), roll.done)


def test_rollout_observations_matches_device_sensor():
    from conan_slam.filters.common import compact
    from conan_slam.sim import sensor_sim
    from conan_slam.sim.precompute import rollout_observations

    world = default_world()
    cfg = SlamConfig()
    n = 1200
    interval = cfg.observe_interval
    n = (n // interval) * interval
    roll = rollout_truth(np.asarray(world.waypoints), cfg, n)
    nz = world.num_landmarks
    obs_roll = rollout_observations(
        roll.x_true, np.asarray(world.landmarks), cfg.max_range, nz, interval
    )

    from conan_slam.core.geometry import wrap_angle

    for f in range(0, n // interval, 7):
        pose = jnp.asarray(roll.x_true[(f + 1) * interval - 1])
        dev = compact(
            sensor_sim.get_observations(pose, world.landmarks, cfg.max_range), nz
        )
        np.testing.assert_array_equal(np.asarray(dev.mask), obs_roll.mask[f])
        np.testing.assert_array_equal(np.asarray(dev.ids), obs_roll.ids[f])
        m = obs_roll.mask[f]
        np.testing.assert_allclose(
            np.asarray(dev.z)[m, 0], obs_roll.z_true[f][m, 0], rtol=1e-5, atol=1e-2
        )
        # Host bearings are wrapped; compare modulo 2*pi.
        db = np.asarray(wrap_angle(np.asarray(dev.z)[m, 1] - obs_roll.z_true[f][m, 1]))
        np.testing.assert_allclose(db, 0.0, atol=1e-5)


def test_precomputed_runner_matches_frame_scan_noise_free():
    """With all noise off the precomputed-rollout runner and the on-device
    frame scan integrate the same filter; trajectories must agree closely."""
    from conan_slam.runner import metrics
    from conan_slam.runner.loop import run_ekf_slam, run_ekf_slam_precomputed

    world = default_world()
    cfg = SlamConfig(
        switch_control_noise=False,
        switch_sensor_noise=False,
        switch_inflate_noise=False,
    )
    key = jax.random.PRNGKey(0)
    n = 3000
    _, outs_a = run_ekf_slam(world, cfg, key, n_steps=n)
    _, outs_b = run_ekf_slam_precomputed(world, cfg, key, n_steps=n)
    valid = ~np.asarray(outs_a.done)
    t = min(np.asarray(outs_b.x_est).shape[0], valid.shape[0])
    err = np.abs(
        np.asarray(outs_a.x_est)[:t][valid[:t], :2]
        - np.asarray(outs_b.x_est)[:t][valid[:t], :2]
    ).max()
    assert err < 0.05, err
    ate_b = metrics.ate_rmse(outs_b.x_true, outs_b.x_est, ~outs_b.done)
    assert float(ate_b) < 0.1, float(ate_b)


def test_native_rollout_matches_python():
    """native/hostsim.cpp mirrors the Python float32 rollout (libm ulp-level
    accumulation differences only); skip when no toolchain."""
    from conan_slam.sim.precompute import rollout_observations

    try:
        from conan_slam.native import rollout_truth_native  # noqa: F401
        import conan_slam.native as native_mod

        native_mod._load_hostsim()
    except Exception:
        import pytest

        pytest.skip("native toolchain unavailable")

    world = default_world()
    cfg = SlamConfig()
    n = 6000
    rp = rollout_truth(np.asarray(world.waypoints), cfg, n, use_native=False)
    rn = rollout_truth(np.asarray(world.waypoints), cfg, n, use_native=True)
    np.testing.assert_allclose(rn.x_true, rp.x_true, atol=2e-3)
    np.testing.assert_allclose(rn.swa, rp.swa, atol=1e-4)
    np.testing.assert_array_equal(rn.done, rp.done)
    np.testing.assert_array_equal(rn.active, rp.active)

    interval = cfg.observe_interval
    nsteps = (n // interval) * interval
    op = rollout_observations(rp.x_true[:nsteps], np.asarray(world.landmarks),
                              cfg.max_range, 30, interval, use_native=False)
    on = rollout_observations(rp.x_true[:nsteps], np.asarray(world.landmarks),
                              cfg.max_range, 30, interval, use_native=True)
    np.testing.assert_array_equal(on.ids, op.ids)
    np.testing.assert_array_equal(on.mask, op.mask)
    np.testing.assert_allclose(on.z_true, op.z_true, atol=2e-3)


def test_rollout_completes_course_with_loops():
    world = default_world()
    roll1 = rollout_truth(np.asarray(world.waypoints), SlamConfig(), 25000)
    assert roll1.done.any()
    t1 = roll1.done.argmax()
    roll2 = rollout_truth(np.asarray(world.waypoints), SlamConfig(number_loops=2), 50000)
    assert roll2.done.any()
    assert roll2.done.argmax() > 1.5 * t1
