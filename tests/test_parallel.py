"""Distributed-execution tests on the 8-device virtual CPU mesh.

Oracle: every sharded kernel must agree with its single-device counterpart
to float32 tolerance (the sharded algebra is a re-bracketing, not an
approximation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_slam.core.linalg import sym
from conan_slam.filters import pf
from conan_slam.ops.cholesky_update import cholesky_update, joseph_update_scalar
from conan_slam.parallel import dist_ekf, dist_pf
from conan_slam.parallel.mesh import PARTICLE_AXIS, STATE_AXIS, make_mesh


def _random_system(rng, d, m):
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.1
    p = a @ a.T + np.eye(d, dtype=np.float32)
    x = rng.normal(size=(d,)).astype(np.float32)
    h = rng.normal(size=(m, d)).astype(np.float32)
    r = np.eye(m, dtype=np.float32) * 0.05
    v = rng.normal(size=(m,)).astype(np.float32)
    return x, p, v, r, h


def test_sharded_cholesky_update_matches_single_device():
    mesh = make_mesh({STATE_AXIS: 8})
    rng = np.random.default_rng(0)
    d, m = 64, 6
    x, p, v, r, h = _random_system(rng, d, m)

    x1, p1 = cholesky_update(jnp.asarray(x), jnp.asarray(p), jnp.asarray(v),
                             jnp.asarray(r), jnp.asarray(h))
    xs, ps = dist_ekf.shard_state(mesh, jnp.asarray(x), jnp.asarray(p))
    x2, p2 = dist_ekf.sharded_cholesky_update(
        mesh, xs, ps, jnp.asarray(v), jnp.asarray(r),
        jnp.zeros((m, 64), jnp.float32).at[:, :d].set(h),
    )
    np.testing.assert_allclose(np.asarray(x2)[:d], np.asarray(x1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(p2)[:d, :d], np.asarray(sym(p1)),
                               rtol=1e-3, atol=1e-3)


def test_sharded_predict_and_heading_match_single_device():
    from conan_slam.filters import ekf

    mesh = make_mesh({STATE_AXIS: 8})
    rng = np.random.default_rng(1)
    cap = 30                      # d = 63 -> padded 64
    state = ekf.init_state(cap, 40)
    d = 3 + 2 * cap
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.1
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.2
    x0 = rng.normal(size=(d,)).astype(np.float32)
    state = state._replace(x=jnp.asarray(x0), p=jnp.asarray(p0),
                           n_active=jnp.int32(cap))

    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    ref = ekf.predict(state, 80.0, 0.05, q, 73.0, 0.01)
    ref = ekf.observe_heading(ref, 0.3, 0.001)

    xs, ps = dist_ekf.shard_state(mesh, state.x, state.p)
    xs, ps = dist_ekf.sharded_predict(mesh, xs, ps, 80.0, 0.05, q, 73.0, 0.01)
    xs, ps = dist_ekf.sharded_observe_heading(mesh, xs, ps, 0.3, 0.001)

    np.testing.assert_allclose(np.asarray(xs)[:d], np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ps)[:d, :d], np.asarray(ref.p),
                               rtol=1e-3, atol=1e-3)


def test_sharded_observation_update_matches_single_device():
    from conan_slam.filters import ekf
    from conan_slam.filters.common import CompactObs

    mesh = make_mesh({STATE_AXIS: 8})
    rng = np.random.default_rng(2)
    cap = 30
    d = 3 + 2 * cap
    feats = rng.uniform(-500, 500, size=(cap, 2)).astype(np.float32)
    state = ekf.init_state(cap, 40)
    x0 = np.zeros((d,), np.float32)
    x0[3:] = feats.reshape(-1)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.05
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.1
    state = state._replace(x=jnp.asarray(x0), p=jnp.asarray(p0),
                           n_active=jnp.int32(cap))

    from conan_slam.models import sensor
    zp, _, _ = sensor.observe(state.pose, jnp.asarray(feats[:4]))
    z = np.asarray(zp) + rng.normal(size=(4, 2)).astype(np.float32) * [0.3, 0.01]
    obs = CompactObs(z=jnp.asarray(z), ids=jnp.arange(4, dtype=jnp.int32),
                     mask=jnp.asarray([True, True, True, False]))
    slots = jnp.asarray([0, 1, 2, 0], jnp.int32)
    mask = jnp.asarray([True, True, True, False])
    r = jnp.asarray(np.diag([0.08, 0.0024]).astype(np.float32))

    ref = ekf.batch_update(state, obs, slots, mask, r)

    xs, ps = dist_ekf.shard_state(mesh, state.x, state.p)
    xs, ps = dist_ekf.sharded_observation_update(
        mesh, xs, ps, obs.z, slots, mask, r, capacity=cap
    )
    np.testing.assert_allclose(np.asarray(xs)[:d], np.asarray(ref.x), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ps)[:d, :d], np.asarray(ref.p),
                               rtol=1e-3, atol=2e-3)


def test_sharded_pf_pipeline_matches_single_device():
    mesh = make_mesh({PARTICLE_AXIS: 8})
    n, k = 64, 4
    ens = pf.init_ensemble(n, k, 8)
    rng = np.random.default_rng(3)
    ens = ens._replace(
        pose=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
        log_w=jnp.asarray(rng.normal(size=(n,)).astype(np.float32)),
    )
    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))

    @jax.jit
    def step(e, key):
        e = pf.predict(e, 80.0, 0.05, q, 73.0, 0.01)
        e = pf.observe_heading(e, 0.1, 0.001)
        return pf.resample(e, key, num_effective=float(n), enabled=True)

    key = jax.random.PRNGKey(0)
    ref = step(ens, key)
    ens_sh = dist_pf.shard_ensemble(mesh, ens)
    out = step(ens_sh, key)
    for name in ("pose", "pose_cov", "log_w"):
        np.testing.assert_allclose(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            rtol=1e-4, atol=1e-5,
        )


def test_sharded_resample_matches_single_device():
    # Explicit shard_map ring-ppermute resample vs the single-device gather,
    # same key => same stratified strata => identical particle selection.
    mesh = make_mesh({PARTICLE_AXIS: 8})
    n, k = 64, 4
    ens = pf.init_ensemble(n, k, 8)
    rng = np.random.default_rng(7)
    ens = ens._replace(
        pose=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
        log_w=jnp.asarray(rng.normal(size=(n,)).astype(np.float32) * 2.0),
        xf=jnp.asarray(rng.normal(size=(n, k, 2)).astype(np.float32)),
    )
    key = jax.random.PRNGKey(5)

    for kind in ("stratified", "systematic"):
        ref = jax.jit(
            lambda e: pf.resample(e, key, num_effective=float(n), enabled=True,
                                  kind=kind)
        )(ens)
        ens_sh = dist_pf.shard_ensemble(mesh, ens)
        out = jax.jit(
            lambda e: dist_pf.sharded_resample(mesh, e, key,
                                               num_effective=float(n), kind=kind)
        )(ens_sh)
        for name in ("pose", "pose_cov", "xf", "pf", "log_w"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
                rtol=1e-5, atol=1e-6, err_msg=f"{kind}:{name}",
            )

    # High-Neff ensemble: resample must be a no-op in both paths.
    ens_flat = ens._replace(log_w=jnp.zeros((n,), jnp.float32))
    out = jax.jit(
        lambda e: dist_pf.sharded_resample(mesh, e, key, num_effective=0.5 * n)
    )(dist_pf.shard_ensemble(mesh, ens_flat))
    np.testing.assert_allclose(
        np.asarray(out.pose), np.asarray(ens_flat.pose), atol=0
    )


def test_sharded_pf_observation_step_matches_single_device():
    """The FULL PF observation block (proposal + feature update + resample +
    new-feature founding + table bookkeeping) under particle sharding must be
    bit-identical to the single-device step (same keys, same strata)."""
    from conan_slam.filters.common import CompactObs
    from conan_slam.models import sensor

    mesh = make_mesh({PARTICLE_AXIS: 8})
    n, cap = 64, 8
    ens = pf.init_ensemble(n, cap, 16)
    rng = np.random.default_rng(11)
    feats = rng.uniform(-200, 200, size=(4, 2)).astype(np.float32)
    xf = np.zeros((n, cap, 2), np.float32)
    xf[:, :4] = feats + rng.normal(size=(n, 4, 2)).astype(np.float32) * 0.5
    pfc = np.broadcast_to(np.eye(2, dtype=np.float32) * 0.4, (n, cap, 2, 2)).copy()
    table = np.full((16,), -1, np.int32)
    table[:4] = np.arange(4)
    ens = ens._replace(
        pose=jnp.asarray(
            rng.normal(size=(n, 3)).astype(np.float32) * [2.0, 2.0, 0.2]
        ),
        pose_cov=jnp.asarray(
            np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (n, 3, 3)).copy()
        ),
        log_w=jnp.asarray(rng.normal(size=(n,)).astype(np.float32)),
        xf=jnp.asarray(xf), pf=jnp.asarray(pfc),
        n_active=jnp.int32(4), table=jnp.asarray(table),
    )
    r = jnp.asarray(np.diag([0.02, 0.0012]).astype(np.float32))
    zp, _, _ = sensor.observe(jnp.zeros(3), jnp.asarray(feats))
    z = np.zeros((6, 2), np.float32)
    z[:4] = np.asarray(zp) + rng.normal(size=(4, 2)).astype(np.float32) * [0.1, 0.005]
    z[4] = [150.0, 0.7]                       # founds a new landmark (id 9)
    obs = CompactObs(z=jnp.asarray(z),
                     ids=jnp.asarray([0, 1, 2, 3, 9, -1], jnp.int32),
                     mask=jnp.asarray([True] * 5 + [False]))
    key = jax.random.PRNGKey(3)

    for kw in (
        dict(num_effective=48.0, sample_proposal_on=True, resample_on=True),
        dict(num_effective=48.0, sample_proposal_on=True, resample_on=True,
             resample_kind="systematic", roughening=0.02),
        dict(num_effective=48.0, sample_proposal_on=False, resample_on=True),
    ):
        ref = jax.jit(lambda e: pf.observation_step(e, obs, r, key, **kw))(ens)
        out = jax.jit(
            lambda e: dist_pf.sharded_observation_step(mesh, e, obs, r, key, **kw)
        )(dist_pf.shard_ensemble(mesh, ens))
        for name in ("pose", "pose_cov", "xf", "pf", "log_w"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
                rtol=1e-6, atol=1e-6, err_msg=f"{kw}:{name}",
            )
        assert int(out.n_active) == int(ref.n_active)
        np.testing.assert_array_equal(np.asarray(out.table), np.asarray(ref.table))


def test_sharded_augment_matches_single_device():
    from conan_slam.filters import ekf
    from conan_slam.filters.common import CompactObs
    from conan_slam.models import sensor

    mesh = make_mesh({STATE_AXIS: 8})
    rng = np.random.default_rng(9)
    cap = 30
    d = 3 + 2 * cap
    n_act = 4
    feats = rng.uniform(-300, 300, size=(n_act, 2)).astype(np.float32)
    state = ekf.init_state(cap, 40)
    x0 = np.zeros((d,), np.float32)
    x0[:3] = [2.0, -1.0, 0.3]
    x0[3:3 + 2 * n_act] = feats.reshape(-1)
    na = 3 + 2 * n_act
    a = rng.normal(size=(na, na)).astype(np.float32) * 0.1
    p0 = np.zeros((d, d), np.float32)
    p0[:na, :na] = a @ a.T + np.eye(na, dtype=np.float32) * 0.2
    table = np.full((40,), -1, np.int32)
    table[:n_act] = np.arange(n_act)
    state = state._replace(x=jnp.asarray(x0), p=jnp.asarray(p0),
                           n_active=jnp.int32(n_act), table=jnp.asarray(table))

    z = jnp.asarray([[120.0, 0.5], [60.0, -0.9], [0.0, 0.0]], jnp.float32)
    ids = jnp.asarray([10, 11, -1], jnp.int32)
    new_mask = jnp.asarray([True, True, False])
    obs = CompactObs(z=z, ids=ids, mask=jnp.asarray([True, True, False]))
    r = jnp.asarray(np.diag([0.08, 0.0024]).astype(np.float32))

    ref = ekf.augment(state, obs, new_mask, r)

    xs, ps = dist_ekf.shard_state(mesh, state.x, state.p)
    xs, ps, n_act_new, table_new = dist_ekf.sharded_augment(
        mesh, xs, ps, z, ids, new_mask, r, state.n_active, state.table
    )
    np.testing.assert_allclose(np.asarray(xs)[:d], np.asarray(ref.x),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ps)[:d, :d], np.asarray(ref.p),
                               rtol=1e-3, atol=1e-3)
    assert int(n_act_new) == int(ref.n_active)
    np.testing.assert_array_equal(np.asarray(table_new), np.asarray(ref.table))


def test_sharded_frame_update_matches_single_device_fused_frame():
    """The ONE-dispatch distributed frame (dist_fastframe) must equal the
    single-device fused frame (frame factors folded into the batched
    measurement update) to float32 tolerance, and an all-inactive frame must
    be an exact no-op."""
    from conan_slam.filters import ekf
    from conan_slam.filters.common import CompactObs
    from conan_slam.filters.ekf.fastframe import frame_factors
    from conan_slam.filters.ekf.update import fused_frame_update
    from conan_slam.models import sensor
    from conan_slam.parallel import dist_fastframe

    mesh = make_mesh({STATE_AXIS: 8})
    rng = np.random.default_rng(4)
    cap = 30
    d = 3 + 2 * cap
    feats = rng.uniform(-500, 500, size=(cap, 2)).astype(np.float32)
    state = ekf.init_state(cap, 40)
    x0 = np.zeros((d,), np.float32)
    x0[:3] = [5.0, -2.0, 0.4]
    x0[3:] = feats.reshape(-1)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.05
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.1
    state = state._replace(x=jnp.asarray(x0), p=jnp.asarray(p0),
                           n_active=jnp.int32(cap))

    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    r = jnp.asarray(np.diag([0.08, 0.0024]).astype(np.float32))
    s_steps = 6
    vns = jnp.asarray(80.0 + rng.normal(size=(s_steps,)).astype(np.float32))
    swans = jnp.asarray(rng.normal(size=(s_steps,)).astype(np.float32) * 0.03)
    phis = jnp.asarray(
        0.4 + np.cumsum(rng.normal(size=(s_steps,)).astype(np.float32) * 0.005)
    )
    act = jnp.ones((s_steps,), bool)

    nz = 5
    zp, _, _ = sensor.observe(state.pose, jnp.asarray(feats[:nz]))
    z = jnp.asarray(
        np.asarray(zp) + rng.normal(size=(nz, 2)).astype(np.float32) * [0.3, 0.01]
    )
    obs = CompactObs(z=z, ids=jnp.arange(nz, dtype=jnp.int32),
                     mask=jnp.asarray([True] * 4 + [False]))
    slots = jnp.asarray([0, 1, 2, 3, 0], jnp.int32)
    mask = jnp.asarray([True, True, True, True, False])
    sigma_h = 0.000175

    st1, pt_ref, vmat, bmat = frame_factors(
        state, vns, swans, phis, act, q, 73.0, 0.01, sigma_h, True
    )
    ref, nis_ref = fused_frame_update(
        st1, vmat, bmat, obs, slots, mask, r, return_nis=True
    )

    xs, ps = dist_ekf.shard_state(mesh, state.x, state.p)
    run = jax.jit(
        lambda xs, ps, act, mask: dist_fastframe.sharded_frame_update(
            mesh, xs, ps, vns, swans, phis, act, q, z, slots, mask, r,
            73.0, 0.01, sigma_h, True,
        )
    )
    xs2, ps2, nis2, pt2 = run(xs, ps, act, mask)
    np.testing.assert_allclose(np.asarray(xs2)[:d], np.asarray(ref.x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ps2)[:d, :d], np.asarray(ref.p),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(nis2), float(nis_ref), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(pt2), np.asarray(pt_ref),
                               rtol=1e-5, atol=1e-5)

    # All-inactive, all-masked frame: exact no-op (modulo the heading wrap).
    xs3, ps3, nis3, _ = run(
        xs, ps, jnp.zeros((s_steps,), bool), jnp.zeros((nz,), bool)
    )
    np.testing.assert_allclose(np.asarray(xs3), np.asarray(xs), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ps3), np.asarray(ps), atol=0)
    assert float(nis3) == 0.0


@pytest.mark.slow
def test_sharded_sim_loop_matches_single_device_statistics():
    """Full sharded EKF sim loop on the 8-device mesh: tracks truth on the
    canonical world (noise-free oracle) and stays close to the single-device
    runner's trajectory."""
    from conan_slam.config import SlamConfig
    from conan_slam.parallel.dist_runner import run_ekf_slam_sharded
    from conan_slam.runner import metrics
    from conan_slam.sim.world import default_world

    mesh = make_mesh({STATE_AXIS: 8})
    world = default_world()
    cfg = SlamConfig(
        switch_control_noise=False,
        switch_sensor_noise=False,
        switch_inflate_noise=False,
    )
    carry, outs = run_ekf_slam_sharded(
        world, cfg, jax.random.PRNGKey(0), mesh, n_steps=2400
    )
    ate = metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done)
    assert float(ate) < 0.1, float(ate)
    assert int(carry.n_active) > 0


def test_sharded_frame_update_i16_gain_wire_close_and_symmetric():
    """gain_wire="i16" (half-wire quantised gain gather) must stay within
    quantisation tolerance of the exact f32 wire AND keep the downdate
    symmetric — the decode is shared by both Gram factors, so asym(P) must
    not grow beyond the f32 path's float noise."""
    from conan_slam.filters import ekf
    from conan_slam.models import sensor
    from conan_slam.parallel import dist_fastframe

    mesh = make_mesh({STATE_AXIS: 8})
    rng = np.random.default_rng(9)
    cap = 30
    d = 3 + 2 * cap
    feats = rng.uniform(-500, 500, size=(cap, 2)).astype(np.float32)
    state = ekf.init_state(cap, 40)
    x0 = np.zeros((d,), np.float32)
    x0[:3] = [5.0, -2.0, 0.4]
    x0[3:] = feats.reshape(-1)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.05
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.1
    state = state._replace(x=jnp.asarray(x0), p=jnp.asarray(p0),
                           n_active=jnp.int32(cap))

    q = jnp.asarray(np.diag([0.18, 0.0006]).astype(np.float32))
    r = jnp.asarray(np.diag([0.08, 0.0024]).astype(np.float32))
    s_steps = 6
    vns = jnp.asarray(80.0 + rng.normal(size=(s_steps,)).astype(np.float32))
    swans = jnp.asarray(rng.normal(size=(s_steps,)).astype(np.float32) * 0.03)
    phis = jnp.asarray(
        0.4 + np.cumsum(rng.normal(size=(s_steps,)).astype(np.float32) * 0.005)
    )
    act = jnp.ones((s_steps,), bool)
    nz = 5
    zp, _, _ = sensor.observe(state.pose, jnp.asarray(feats[:nz]))
    z = jnp.asarray(
        np.asarray(zp) + rng.normal(size=(nz, 2)).astype(np.float32) * [0.3, 0.01]
    )
    slots = jnp.arange(nz, dtype=jnp.int32)
    mask = jnp.ones((nz,), bool)
    sigma_h = 0.000175

    xs, ps = dist_ekf.shard_state(mesh, state.x, state.p)

    def run(wire):
        return jax.jit(
            lambda xs, ps: dist_fastframe.sharded_frame_update(
                mesh, xs, ps, vns, swans, phis, act, q, z, slots, mask, r,
                73.0, 0.01, sigma_h, True, gain_wire=wire,
            )
        )(xs, ps)

    x_f, p_f, nis_f, _ = run("f32")
    x_q, p_q, nis_q, _ = run("i16")

    p_fn = np.asarray(p_f)[:d, :d]
    p_qn = np.asarray(p_q)[:d, :d]
    scale = np.abs(p_fn).max()
    # Quantisation error bounded well below 1e-3 of the covariance scale.
    assert np.abs(p_qn - p_fn).max() < 1e-3 * scale
    # The mean keeps the exact local strip: tight agreement.
    np.testing.assert_allclose(np.asarray(x_q), np.asarray(x_f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(nis_q), float(nis_f), rtol=1e-4)
    # Symmetry: the shared decode keeps the downdate Gram-symmetric.
    asym_q = np.abs(p_qn - p_qn.T).max()
    asym_f = np.abs(p_fn - p_fn.T).max()
    assert asym_q <= asym_f + 1e-6, (asym_q, asym_f)
