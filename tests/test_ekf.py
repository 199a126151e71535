"""EKF-SLAM unit and end-to-end tests.

The update/augment/predict kernels are checked against straightforward dense
NumPy constructions of the same math (reference EKF.cpp formulas); the
end-to-end oracle is the reference's implicit one (SURVEY.md section 4):
with noise switches off and known association, the filter must track ground
truth to numerical precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_slam.config import SlamConfig
from conan_slam.filters import ekf
from conan_slam.filters.common import CompactObs, compact
from conan_slam.models import sensor
from conan_slam.ops.cholesky_update import cholesky_update, joseph_update, joseph_update_scalar
from conan_slam.runner import metrics
from conan_slam.runner.loop import run_ekf_slam
from conan_slam.sim import sensor_sim
from conan_slam.sim.world import default_world


def _random_spd(rng, n, scale=1.0):
    a = rng.normal(size=(n, n)).astype(np.float32) * scale
    return a @ a.T + np.eye(n, dtype=np.float32) * 0.1


def test_cholesky_update_matches_closed_form_kf():
    rng = np.random.default_rng(42)
    d, m = 7, 4
    p = _random_spd(rng, d)
    h = rng.normal(size=(m, d)).astype(np.float32)
    r = _random_spd(rng, m, 0.3)
    x = rng.normal(size=(d,)).astype(np.float32)
    v = rng.normal(size=(m,)).astype(np.float32)

    x2, p2 = cholesky_update(jnp.asarray(x), jnp.asarray(p), jnp.asarray(v),
                             jnp.asarray(r), jnp.asarray(h))
    s = h @ p @ h.T + r
    w = p @ h.T @ np.linalg.inv(s)
    np.testing.assert_allclose(x2, x + w @ v, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p2, p - w @ s @ w.T, rtol=2e-3, atol=2e-3)

    # Joseph form agrees with the simple form on the mean and covariance.
    x3, p3 = joseph_update(jnp.asarray(x), jnp.asarray(p), jnp.asarray(v),
                           jnp.asarray(r), jnp.asarray(h))
    np.testing.assert_allclose(x3, x2, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p3, p2, rtol=2e-3, atol=2e-3)


def test_joseph_scalar_matches_general():
    rng = np.random.default_rng(3)
    d = 9
    p = _random_spd(rng, d)
    x = rng.normal(size=(d,)).astype(np.float32)
    v, r = 0.37, 0.01
    h = np.zeros((1, d), np.float32)
    h[0, 2] = 1.0
    x_g, p_g = joseph_update(jnp.asarray(x), jnp.asarray(p),
                             jnp.asarray([v]), jnp.asarray([[r]]), jnp.asarray(h))
    x_s, p_s = joseph_update_scalar(jnp.asarray(x), jnp.asarray(p), v, r, idx=2)
    np.testing.assert_allclose(x_s, x_g, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p_s, p_g, rtol=1e-3, atol=1e-3)


def test_predict_matches_dense_propagation():
    rng = np.random.default_rng(7)
    cap, n_act = 4, 2
    d = 3 + 2 * cap
    state = ekf.init_state(cap, 10)
    p_full = np.zeros((d, d), np.float32)
    na = 3 + 2 * n_act
    p_full[:na, :na] = _random_spd(rng, na)
    x0 = rng.normal(size=(d,)).astype(np.float32)
    state = state._replace(x=jnp.asarray(x0), p=jnp.asarray(p_full),
                           n_active=jnp.int32(n_act))

    v, swa, q = 50.0, 0.1, np.diag([0.09, 0.0003]).astype(np.float32)
    out = ekf.predict(state, v, swa, jnp.asarray(q), 73.0, 0.01)

    # Dense equivalent: G P G^T + Q_full with G = blockdiag(Gv, I).
    from conan_slam.models import motion
    gv, gu = motion.jacobians(jnp.asarray(x0[:3]), v, swa, 73.0, 0.01)
    g = np.eye(d, dtype=np.float32)
    g[:3, :3] = np.asarray(gv)
    qf = np.zeros((d, d), np.float32)
    qf[:3, :3] = np.asarray(gu) @ q @ np.asarray(gu).T
    expected = g @ p_full @ g.T + qf
    np.testing.assert_allclose(out.p, expected, rtol=1e-3, atol=1e-3)


def _make_state_with_features(rng, cap, feats, num_ids=16):
    """Active EKF state with given feature positions and a random SPD P."""
    n = feats.shape[0]
    d = 3 + 2 * cap
    na = 3 + 2 * n
    state = ekf.init_state(cap, num_ids)
    x = np.zeros((d,), np.float32)
    x[:3] = [1.0, -2.0, 0.4]
    x[3:na] = feats.reshape(-1)
    p = np.zeros((d, d), np.float32)
    p[:na, :na] = _random_spd(rng, na, 0.05)
    table = np.full((num_ids,), -1, np.int32)
    table[:n] = np.arange(n)
    return state._replace(
        x=jnp.asarray(x), p=jnp.asarray(p), n_active=jnp.int32(n),
        table=jnp.asarray(table),
    )


def test_batch_update_matches_dense_reference_math():
    rng = np.random.default_rng(11)
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0], [5.0, -40.0]], np.float32)
    state = _make_state_with_features(rng, cap=5, feats=feats)
    d = state.x.shape[0]

    # Observe features 0 and 2 (slots 0, 2).
    z = np.zeros((4, 2), np.float32)
    zp0, _, _ = sensor.observe(state.pose, jnp.asarray(feats[0]))
    zp2, _, _ = sensor.observe(state.pose, jnp.asarray(feats[2]))
    z[0] = np.asarray(zp0) + [0.5, 0.01]
    z[1] = np.asarray(zp2) + [-0.3, -0.02]
    obs = CompactObs(
        z=jnp.asarray(z),
        ids=jnp.asarray([0, 2, -1, -1], jnp.int32),
        mask=jnp.asarray([True, True, False, False]),
    )
    slots = jnp.asarray([0, 2, 0, 0], jnp.int32)
    mask = jnp.asarray([True, True, False, False])
    r = np.diag([0.01, 0.0003]).astype(np.float32)

    out = ekf.batch_update(state, obs, slots, mask, jnp.asarray(r))

    # Dense NumPy reference: stack H rows for the two measurements.
    x0 = np.asarray(state.x)
    p0 = np.asarray(state.p)
    h = np.zeros((4, d), np.float32)
    v = np.zeros((4,), np.float32)
    for row, (slot, zi) in enumerate([(0, z[0]), (2, z[1])]):
        zp, hv, hf = sensor.observe(state.pose, jnp.asarray(feats[slot if slot != 2 else 2]))
        zp, hv, hf = np.asarray(zp), np.asarray(hv), np.asarray(hf)
        h[2 * row: 2 * row + 2, :3] = hv
        h[2 * row: 2 * row + 2, 3 + 2 * slot: 5 + 2 * slot] = hf
        v[2 * row] = zi[0] - zp[0]
        dv = zi[1] - zp[1]
        v[2 * row + 1] = (dv + np.pi) % (2 * np.pi) - np.pi
    rr = np.kron(np.eye(2, dtype=np.float32), r)
    s = h @ p0 @ h.T + rr
    w = p0 @ h.T @ np.linalg.inv(s)
    np.testing.assert_allclose(out.x, x0 + w @ v, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.p, p0 - w @ s @ w.T, rtol=1e-2, atol=1e-3)


def test_enable_augment_off_is_noop_at_full_capacity():
    """config.enable_augment=False (compile out the augment branch) must be
    bit-identical on a full-map steady-state run — augment at capacity drops
    every candidate slot, so the branch is a guaranteed no-op there."""
    from conan_slam.config import SlamConfig
    from conan_slam.filters.ekf import init_state_with_map
    from conan_slam.runner.loop import run_ekf_slam
    from conan_slam.sim.world import default_world

    world = default_world()
    state0 = init_state_with_map(world.landmarks, sigma0=1.0)
    outs = {}
    for flag in (True, False):
        cfg = SlamConfig(max_landmarks=world.num_landmarks,
                         enable_augment=flag)
        carry, o = run_ekf_slam(
            world, cfg, jax.random.PRNGKey(5), n_steps=600, init_state=state0
        )
        outs[flag] = (np.asarray(carry.state.x), np.asarray(o.x_est))
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    np.testing.assert_array_equal(outs[True][1], outs[False][1])


def _sequential_oracle(x0, p0, z_list, slot_list, r, dtype=np.float64):
    """Dense per-measurement NumPy reference of ``sequential_update``:
    for each measurement IN BUFFER ORDER, re-derive the observation model at
    the CURRENT mean (reference EKF::singleUpdate loops observeModel +
    choleskyUpdate per measurement, EKF.cpp:457-479), then apply the
    Cholesky-form KF update P -= W1 W1^T."""
    x = np.asarray(x0, dtype).copy()
    p = np.asarray(p0, dtype).copy()
    r = np.asarray(r, dtype)
    for z_i, slot in zip(z_list, slot_list):
        fx, fy = x[3 + 2 * slot], x[4 + 2 * slot]
        dx, dy = fx - x[0], fy - x[1]
        d2 = dx * dx + dy * dy
        d = np.sqrt(d2)
        zp = np.asarray([d, np.arctan2(dy, dx) - x[2]])
        h = np.zeros((2, x.shape[0]), dtype)
        h[0, :3] = [-dx / d, -dy / d, 0.0]
        h[1, :3] = [dy / d2, -dx / d2, -1.0]
        h[0, 3 + 2 * slot: 5 + 2 * slot] = [dx / d, dy / d]
        h[1, 3 + 2 * slot: 5 + 2 * slot] = [-dy / d2, dx / d2]
        v = np.asarray(z_i, dtype) - zp
        v[1] = (v[1] + np.pi) % (2 * np.pi) - np.pi
        pht = p @ h.T
        s = h @ pht + r
        s = 0.5 * (s + s.T)
        w = pht @ np.linalg.inv(s)
        x = x + w @ v
        p = p - w @ s @ w.T
        p = 0.5 * (p + p.T)
    x[2] = (x[2] + np.pi) % (2 * np.pi) - np.pi
    return x, p


def test_sequential_update_matches_dense_per_measurement_oracle():
    """SURVEY section 7.3 item 2: sequential semantics are order-dependent
    and must not be silently parallelised.  Asserts (a) equality with a
    float64 dense per-measurement oracle, (b) that reversing the buffer
    changes the result, and (c) that the implementation tracks the oracle
    under that reversal too — i.e. the order dependence itself is correct,
    not just one ordering."""
    rng = np.random.default_rng(13)
    feats = np.asarray(
        [[30.0, 10.0], [-20.0, 25.0], [12.0, -18.0]], np.float32
    )
    state = _make_state_with_features(rng, cap=4, feats=feats)
    z = np.zeros((3, 2), np.float32)
    for i in range(3):
        zp_i, _, _ = sensor.observe(state.pose, jnp.asarray(feats[i]))
        z[i] = np.asarray(zp_i) + [0.5 - 0.3 * i, 0.01 * (i + 1)]
    r = np.diag([0.01, 0.0003]).astype(np.float32)
    slots_np = np.asarray([0, 1, 2])

    def run_impl(order):
        obs = CompactObs(
            z=jnp.asarray(z[order]),
            ids=jnp.asarray(slots_np[order], jnp.int32),
            mask=jnp.asarray([True] * 3),
        )
        return ekf.sequential_update(
            state, obs, jnp.asarray(slots_np[order], jnp.int32),
            jnp.asarray([True] * 3), jnp.asarray(r),
        )

    fwd = np.asarray([0, 1, 2])
    rev = np.asarray([2, 1, 0])
    out_f = run_impl(fwd)
    out_r = run_impl(rev)
    xo_f, po_f = _sequential_oracle(state.x, state.p, z[fwd], slots_np[fwd], r)
    xo_r, po_r = _sequential_oracle(state.x, state.p, z[rev], slots_np[rev], r)

    np.testing.assert_allclose(np.asarray(out_f.x), xo_f, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out_f.p), po_f, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out_r.x), xo_r, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out_r.p), po_r, rtol=1e-3, atol=2e-4)

    # Order dependence is real: both the oracle and the implementation must
    # move by more than float noise between orderings, and by the SAME gap.
    gap_oracle = np.max(np.abs(xo_f - xo_r))
    gap_impl = float(jnp.max(jnp.abs(out_f.x - out_r.x)))
    assert gap_oracle > 1e-6, gap_oracle
    np.testing.assert_allclose(gap_impl, gap_oracle, rtol=1e-2, atol=1e-5)

    # Single measurement: batch and sequential coincide (sanity anchor).
    obs1 = CompactObs(
        z=jnp.asarray(z[:1]), ids=jnp.asarray([0], jnp.int32),
        mask=jnp.asarray([True]),
    )
    out_b = ekf.batch_update(
        state, obs1, jnp.asarray([0], jnp.int32), jnp.asarray([True]),
        jnp.asarray(r),
    )
    out_s = ekf.sequential_update(
        state, obs1, jnp.asarray([0], jnp.int32), jnp.asarray([True]),
        jnp.asarray(r),
    )
    np.testing.assert_allclose(out_s.x, out_b.x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_s.p, out_b.p, rtol=1e-3, atol=1e-4)


def test_augment_matches_sequential_dense_construction():
    rng = np.random.default_rng(17)
    feats = np.asarray([[30.0, 10.0]], np.float32)
    state = _make_state_with_features(rng, cap=4, feats=feats)
    d = state.x.shape[0]

    z_new = np.asarray([[50.0, 0.3], [80.0, -0.7]], np.float32)
    obs = CompactObs(
        z=jnp.asarray(np.vstack([z_new, np.zeros((1, 2), np.float32)])),
        ids=jnp.asarray([5, 6, -1], jnp.int32),
        mask=jnp.asarray([True, True, False]),
    )
    new_mask = jnp.asarray([True, True, False])
    r = np.diag([0.01, 0.0003]).astype(np.float32)
    out = ekf.augment(state, obs, new_mask, jnp.asarray(r))

    assert int(out.n_active) == 3
    assert int(out.table[5]) == 1 and int(out.table[6]) == 2

    # Sequential dense construction (reference EKF.cpp:28-91) in NumPy.
    x = np.asarray(state.x).copy()
    p = np.asarray(state.p).copy()
    n_act = 1
    for zi in z_new:
        xf, gv, gz = sensor.init_feature(jnp.asarray(x[:3]), jnp.asarray(zi))
        xf, gv, gz = np.asarray(xf), np.asarray(gv), np.asarray(gz)
        ln = 3 + 2 * n_act
        x[ln:ln + 2] = xf
        pvv = p[:3, :3]
        p[ln:ln + 2, ln:ln + 2] = gv @ pvv @ gv.T + gz @ r @ gz.T
        p[ln:ln + 2, :3] = gv @ pvv
        p[:3, ln:ln + 2] = (gv @ pvv).T
        p[ln:ln + 2, 3:ln] = gv @ p[:3, 3:ln]
        p[3:ln, ln:ln + 2] = (gv @ p[:3, 3:ln]).T
        n_act += 1
    np.testing.assert_allclose(out.x, x, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out.p, p, rtol=1e-3, atol=1e-4)


def test_associate_known_and_gated():
    rng = np.random.default_rng(19)
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    state = _make_state_with_features(rng, cap=4, feats=feats)
    r = jnp.asarray(np.diag([0.01, 0.0003]).astype(np.float32))

    zp, _, _ = sensor.observe(state.pose, jnp.asarray(feats))
    obs = CompactObs(
        z=jnp.concatenate([zp, jnp.asarray([[500.0, 1.0]])], axis=0),
        ids=jnp.asarray([0, 1, 7], jnp.int32),
        mask=jnp.asarray([True, True, True]),
    )
    known = ekf.associate_known(state, obs)
    np.testing.assert_array_equal(known.known_mask, [True, True, False])
    np.testing.assert_array_equal(known.new_mask, [False, False, True])
    np.testing.assert_array_equal(known.slots[:2], [0, 1])

    gated = ekf.associate_gated(state, obs, r, gate_reject=50.0, gate_augment=1000.0)
    np.testing.assert_array_equal(gated.known_mask, [True, True, False])
    np.testing.assert_array_equal(gated.slots[:2], [0, 1])
    # The far measurement has huge NIS -> new feature.
    assert bool(gated.new_mask[2])


@pytest.mark.slow
def test_e2e_noise_free_tracks_truth():
    """Reference's implicit correctness oracle (SURVEY.md section 4):
    perfect odometry + perfect measurements + known association => the EKF
    trajectory matches ground truth to numerical precision."""
    cfg = SlamConfig(
        switch_control_noise=False,
        switch_sensor_noise=False,
        switch_inflate_noise=False,
    )
    world = default_world()
    carry, outs = run_ekf_slam(world, cfg, jax.random.PRNGKey(0), n_steps=3000)
    valid = ~outs.done
    ate = metrics.ate_rmse(outs.x_true, outs.x_est, valid)
    assert float(ate) < 0.1, f"noise-free ATE too high: {float(ate)}"
    # Landmarks seen so far should be mapped.
    assert int(carry.state.n_active) > 0


@pytest.mark.slow
def test_e2e_gated_association_tracks_truth():
    """BASELINE config 2's association mode: Mahalanobis-gated NN (unknown
    correspondences) through the fused fast path.  Noise-free oracle: the
    gated filter must still track truth and register the visible landmarks."""
    cfg = SlamConfig(
        switch_control_noise=False,
        switch_sensor_noise=False,
        switch_inflate_noise=False,
        switch_association_known=False,
    )
    world = default_world()
    carry, outs = run_ekf_slam(world, cfg, jax.random.PRNGKey(0), n_steps=3000)
    valid = ~outs.done
    ate = metrics.ate_rmse(outs.x_true, outs.x_est, valid)
    assert float(ate) < 0.1, f"gated noise-free ATE too high: {float(ate)}"
    assert int(carry.state.n_active) > 0


def test_init_state_with_map_tracks_immediately():
    """Steady-state start: all features registered; the filter should track
    with small error from step one (the full-map benchmark configuration)."""
    rng = np.random.default_rng(3)
    lm = rng.uniform(-500.0, 500.0, size=(6, 2)).astype(np.float32)
    state = ekf.init_state_with_map(jnp.asarray(lm), sigma0=0.5)
    assert int(state.n_active) == 6
    np.testing.assert_array_equal(np.asarray(state.table), np.arange(6))
    np.testing.assert_allclose(np.asarray(state.features), lm, atol=1e-5)
    # Covariance: zero pose block, sigma0^2 I feature blocks.
    p = np.asarray(state.p)
    np.testing.assert_allclose(p[:3, :3], 0.0)
    np.testing.assert_allclose(np.diag(p)[3:15], 0.25, atol=1e-6)


def test_nis_chi2_consistency():
    """Filter-consistency telemetry: per-measurement NIS must be chi^2_2-
    consistent over the canonical run (SURVEY.md section 5 observability).

    With the filter running at the TRUE noise covariances the normalised
    innovation squared per 2-D measurement has E[NIS] = 2; with the
    reference's default 8x R inflation (slam.h: QE/RE switches) innovations
    are whitened by an 8x-too-large S, scaling E[NIS] to ~2/8.  Both bounds
    together catch divergence (NIS >> dof), covariance collapse (NIS -> 0),
    and a wrong inflation wiring — none of which per-frame algebra tests see.
    """
    from conan_slam.runner.loop import run_ekf_slam_precomputed

    world = default_world()

    _, outs = run_ekf_slam_precomputed(
        world, SlamConfig(switch_inflate_noise=False), jax.random.PRNGKey(3),
        n_steps=2400,
    )
    nis = np.asarray(outs.consistency)
    nis = nis[nis != 0.0]
    assert nis.size > 300
    assert np.all(np.isfinite(nis))
    # Frame-mean NIS over ~40 measurements concentrates hard around 2.
    assert 1.6 < nis.mean() < 2.5, nis.mean()
    assert nis.max() < 15.0, nis.max()

    _, outs_infl = run_ekf_slam_precomputed(
        world, SlamConfig(), jax.random.PRNGKey(3), n_steps=2400,
    )
    nis_i = np.asarray(outs_infl.consistency)
    nis_i = nis_i[nis_i != 0.0]
    assert 0.1 < nis_i.mean() < 0.6, nis_i.mean()

    # The non-fused path (plain observation_step through update()) must
    # report the same telemetry — it was hard-zero before round 3.
    _, outs_nf = run_ekf_slam(
        world,
        SlamConfig(switch_inflate_noise=False, fast_frame=False,
                   fused_obs=False),
        jax.random.PRNGKey(3), n_steps=1200,
    )
    nis_nf = np.asarray(outs_nf.consistency)
    nis_nf = nis_nf[nis_nf != 0.0]
    assert nis_nf.size > 100
    assert 1.2 < nis_nf.mean() < 3.0, nis_nf.mean()


def test_chunked_driver_matches_oneshot():
    """run_ekf_slam_precomputed_chunked must stitch the same workload: shared
    truth rollout, same output shapes, equivalent tracking (noise keys fold
    per chunk, so realisations differ like seeds do)."""
    from conan_slam.runner.loop import (
        precompute_rollout,
        run_ekf_slam_precomputed,
        run_ekf_slam_precomputed_chunked,
    )

    world = default_world()
    cfg = SlamConfig()
    roll = precompute_rollout(world, cfg, 1200)
    _, o1 = run_ekf_slam_precomputed(
        world, cfg, jax.random.PRNGKey(5), n_steps=1200, precomputed=roll
    )
    _, o2 = run_ekf_slam_precomputed_chunked(
        world, cfg, jax.random.PRNGKey(5), n_steps=1200, chunk_steps=420,
        precomputed=roll,
    )
    assert np.asarray(o2.x_est).shape == np.asarray(o1.x_est).shape
    np.testing.assert_array_equal(np.asarray(o1.x_true), np.asarray(o2.x_true))
    a1 = float(metrics.ate_rmse(o1.x_true, o1.x_est, ~o1.done))
    a2 = float(metrics.ate_rmse(o2.x_true, o2.x_est, ~o2.done))
    assert np.isfinite(a2) and abs(a1 - a2) < 0.5, (a1, a2)

