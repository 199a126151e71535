"""Rank-compounded frame update vs the sequential per-step implementation.

The compounded form must agree with S iterations of predict + observe_heading
to float32 tolerance — it is an algebraic re-bracketing, not an approximation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_slam.filters import ekf
from conan_slam.filters.ekf.fastframe import frame_predict_heading


def _active_state(rng, cap, n_act, num_ids=40):
    d = 3 + 2 * cap
    state = ekf.init_state(cap, num_ids)
    na = 3 + 2 * n_act
    a = rng.normal(size=(na, na)).astype(np.float32) * 0.1
    p = np.zeros((d, d), np.float32)
    p[:na, :na] = a @ a.T + np.eye(na, dtype=np.float32) * 0.3
    x = np.zeros((d,), np.float32)
    x[:3] = [5.0, -3.0, 0.4]
    x[3:na] = rng.uniform(-200, 200, size=(na - 3,)).astype(np.float32)
    return state._replace(x=jnp.asarray(x), p=jnp.asarray(p),
                          n_active=jnp.int32(n_act))


def _sequential_f64(x0, p0, vns, swans, phis, q, wb, dt, sig_h, use_heading):
    """Float64 NumPy oracle of the S-step predict+heading sequence."""
    x = np.asarray(x0, np.float64).copy()
    p = np.asarray(p0, np.float64).copy()
    q = np.asarray(q, np.float64)
    r = float(sig_h) ** 2
    d = x.shape[0]
    for k in range(len(vns)):
        v, swa = float(vns[k]), float(swans[k])
        phi = x[2]
        a = swa + phi
        gv02, gv12 = -v * dt * np.sin(a), v * dt * np.cos(a)
        gu = np.array([
            [dt * np.cos(a), -v * dt * np.sin(a)],
            [dt * np.sin(a), v * dt * np.cos(a)],
            [dt * np.sin(swa) / wb, v * dt * np.cos(swa) / wb],
        ])
        g = np.eye(d)
        g[0, 2] = gv02
        g[1, 2] = gv12
        p = g @ p @ g.T
        p[:3, :3] += gu @ q @ gu.T
        x[0] += v * dt * np.cos(a)
        x[1] += v * dt * np.sin(a)
        x[2] = (x[2] + v * dt * np.sin(swa) / wb + np.pi) % (2 * np.pi) - np.pi
        if use_heading:
            pc = p[:, 2].copy()
            s = pc[2] + r
            w = pc / s
            innov = (float(phis[k]) - x[2] + np.pi) % (2 * np.pi) - np.pi
            x = x + w * innov
            x[2] = (x[2] + np.pi) % (2 * np.pi) - np.pi
            p = p - np.outer(w, pc) - np.outer(pc, w) + s * np.outer(w, w)
    return x, p


@pytest.mark.parametrize("use_heading,sigma_h,x_atol", [
    # Well-conditioned heading noise: tight agreement checks the algebra.
    (True, 0.05, 2e-4),
    (False, 0.05, 2e-4),
])
def test_fastframe_matches_sequential(use_heading, sigma_h, x_atol):
    rng = np.random.default_rng(5)
    state = _active_state(rng, cap=12, n_act=9)
    s_steps = 6
    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    vns = jnp.asarray(83.33 + rng.normal(size=s_steps).astype(np.float32) * 0.3)
    swans = jnp.asarray(0.1 + rng.normal(size=s_steps).astype(np.float32) * 0.02)
    phis = jnp.asarray(0.4 + np.cumsum(rng.normal(size=s_steps)).astype(np.float32) * 0.01)
    active = jnp.ones((s_steps,), bool)

    # Sequential reference.
    seq = state
    for k in range(s_steps):
        seq = ekf.predict(seq, vns[k], swans[k], q, 73.0, 0.01)
        if use_heading:
            seq = ekf.observe_heading(seq, phis[k], sigma_h)

    fast = frame_predict_heading(
        state, vns, swans, phis, active, q, 73.0, 0.01, sigma_h, use_heading
    )
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(seq.x),
                               rtol=1e-4, atol=x_atol)
    np.testing.assert_allclose(np.asarray(fast.p), np.asarray(seq.p),
                               rtol=2e-3, atol=2e-3)


def test_fastframe_realistic_sigma_vs_f64_oracle():
    """At the reference's heading sigma (0.01 deg, r ~ 3e-8) the gain
    w = P[:,2]/s amplifies float32 cancellation noise enormously in *any*
    implementation order.  Against a float64 oracle, the compounded form must
    be no less accurate than the sequential float32 form (same noise class,
    not a new approximation)."""
    rng = np.random.default_rng(11)
    state = _active_state(rng, cap=12, n_act=9)
    s_steps = 6
    sigma_h = 0.01 * np.pi / 180.0
    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    vns = jnp.asarray(83.33 + rng.normal(size=s_steps).astype(np.float32) * 0.3)
    swans = jnp.asarray(0.1 + rng.normal(size=s_steps).astype(np.float32) * 0.02)
    phis = jnp.asarray(0.4 + np.cumsum(rng.normal(size=s_steps)).astype(np.float32) * 0.002)

    x64, p64 = _sequential_f64(state.x, state.p, vns, swans, phis, q, 73.0,
                               0.01, sigma_h, True)

    seq = state
    for k in range(s_steps):
        seq = ekf.predict(seq, vns[k], swans[k], q, 73.0, 0.01)
        seq = ekf.observe_heading(seq, phis[k], sigma_h)
    fast = frame_predict_heading(
        state, vns, swans, phis, jnp.ones((s_steps,), bool), q, 73.0, 0.01,
        sigma_h, True,
    )

    err_seq_x = np.abs(np.asarray(seq.x, np.float64) - x64).max()
    err_fast_x = np.abs(np.asarray(fast.x, np.float64) - x64).max()
    err_seq_p = np.abs(np.asarray(seq.p, np.float64) - p64).max()
    err_fast_p = np.abs(np.asarray(fast.p, np.float64) - p64).max()
    assert err_fast_x <= 3.0 * err_seq_x + 1e-4, (err_fast_x, err_seq_x)
    assert err_fast_p <= 3.0 * err_seq_p + 1e-5, (err_fast_p, err_seq_p)


def test_fastframe_respects_done_mask():
    rng = np.random.default_rng(7)
    state = _active_state(rng, cap=8, n_act=5)
    s_steps = 6
    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    vns = jnp.full((s_steps,), 83.33, jnp.float32)
    swans = jnp.full((s_steps,), 0.05, jnp.float32)
    phis = jnp.full((s_steps,), 0.4, jnp.float32)
    sigma_h = 0.001

    # Only the first 3 sub-steps active -> equals sequential over 3 steps.
    active = jnp.asarray([True, True, True, False, False, False])
    seq = state
    for k in range(3):
        seq = ekf.predict(seq, vns[k], swans[k], q, 73.0, 0.01)
        seq = ekf.observe_heading(seq, phis[k], sigma_h)
    fast = frame_predict_heading(
        state, vns, swans, phis, active, q, 73.0, 0.01, sigma_h, True
    )
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(seq.x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(fast.p), np.asarray(seq.p),
                               rtol=2e-3, atol=2e-3)

    # All-inactive frame is a no-op.
    fast0 = frame_predict_heading(
        state, vns, swans, phis, jnp.zeros((s_steps,), bool), q, 73.0, 0.01,
        sigma_h, True,
    )
    np.testing.assert_allclose(np.asarray(fast0.x), np.asarray(state.x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fast0.p), np.asarray(state.p), atol=1e-5)


def test_associate_gated_virtual_matches_materialized():
    """Gating against the virtual covariance P + V B V^T (fastframe factors)
    must reproduce gating against the materialised frame covariance."""
    from conan_slam.filters.ekf.fastframe import frame_factors
    from conan_slam.filters.common import CompactObs
    from conan_slam.models import sensor

    rng = np.random.default_rng(33)
    state = _active_state(rng, cap=10, n_act=7)
    s_steps = 6
    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    vns = jnp.asarray(83.33 + rng.normal(size=s_steps).astype(np.float32) * 0.3)
    swans = jnp.asarray(0.1 + rng.normal(size=s_steps).astype(np.float32) * 0.02)
    phis = jnp.asarray(0.4 + np.cumsum(rng.normal(size=s_steps)).astype(np.float32) * 0.002)
    active = jnp.ones((s_steps,), bool)
    args = (vns, swans, phis, active, q, 73.0, 0.01, 0.02, True)
    r = jnp.asarray(np.diag([0.08, 0.0024]).astype(np.float32))

    mat = frame_predict_heading(state, *args)
    st_f, _, vmat, bmat = frame_factors(state, *args)

    # Measurements: three near known features, one far (new), one masked.
    feats = np.asarray(mat.features[:3])
    zp, _, _ = sensor.observe(mat.pose, jnp.asarray(feats))
    z = jnp.concatenate([
        jnp.asarray(np.asarray(zp) + rng.normal(size=(3, 2)).astype(np.float32) * [0.2, 0.005]),
        jnp.asarray([[900.0, 1.2], [100.0, -0.5]]),
    ])
    obs = CompactObs(z=z, ids=jnp.asarray([0, 1, 2, 50, 51], jnp.int32),
                     mask=jnp.asarray([True, True, True, True, False]))

    ga = ekf.associate_gated(mat, obs, r, 50.0, 1000.0)
    gb = ekf.associate_gated(st_f, obs, r, 50.0, 1000.0, vmat, bmat)
    np.testing.assert_array_equal(np.asarray(ga.known_mask), np.asarray(gb.known_mask))
    np.testing.assert_array_equal(np.asarray(ga.new_mask), np.asarray(gb.new_mask))
    known = np.asarray(ga.known_mask)
    np.testing.assert_array_equal(np.asarray(ga.slots)[known], np.asarray(gb.slots)[known])
    assert known[:3].all() and not known[3:].any()


def test_fused_frame_update_matches_materialized_path():
    """frame_factors + fused_frame_update == frame_predict_heading +
    batch_update (the same frame, two data flows)."""
    from conan_slam.filters.ekf.fastframe import frame_factors
    from conan_slam.filters.common import CompactObs
    from conan_slam.models import sensor

    rng = np.random.default_rng(21)
    state = _active_state(rng, cap=10, n_act=7)
    s_steps = 6
    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    vns = jnp.asarray(83.33 + rng.normal(size=s_steps).astype(np.float32) * 0.3)
    swans = jnp.asarray(0.1 + rng.normal(size=s_steps).astype(np.float32) * 0.02)
    phis = jnp.asarray(0.4 + np.cumsum(rng.normal(size=s_steps)).astype(np.float32) * 0.002)
    active = jnp.ones((s_steps,), bool)
    sig = 0.02
    args = (vns, swans, phis, active, q, 73.0, 0.01, sig, True)

    # Path A: materialise P then batch update.
    mat = frame_predict_heading(state, *args)
    feats = np.asarray(mat.features[:3])
    zp, _, _ = sensor.observe(mat.pose, jnp.asarray(feats))
    z = jnp.asarray(np.asarray(zp) + rng.normal(size=(3, 2)).astype(np.float32) * [0.2, 0.01])
    obs = CompactObs(z=z, ids=jnp.arange(3, dtype=jnp.int32),
                     mask=jnp.ones((3,), bool))
    slots = jnp.arange(3, dtype=jnp.int32)
    mask = jnp.ones((3,), bool)
    r = jnp.asarray(np.diag([0.08, 0.0024]).astype(np.float32))
    ref = ekf.batch_update(mat, obs, slots, mask, r)

    # Path B: factors + fused update.
    st_f, _, vmat, bmat = frame_factors(state, *args)
    fused = ekf.fused_frame_update(st_f, vmat, bmat, obs, slots, mask, r)
    np.testing.assert_allclose(np.asarray(fused.x), np.asarray(ref.x),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(fused.p), np.asarray(ref.p),
                               rtol=1e-3, atol=2e-3)
