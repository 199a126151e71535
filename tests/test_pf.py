"""FastSLAM 2.0 particle filter tests: per-kernel checks + e2e oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_slam.config import SlamConfig
from conan_slam.filters import pf
from conan_slam.filters.common import CompactObs
from conan_slam.models import sensor
from conan_slam.runner import metrics
from conan_slam.runner.loop import run_pf_slam
from conan_slam.sim.world import default_world


def _ens_with_features(n=8, k=4, feats=None, num_ids=12):
    ens = pf.init_ensemble(n, k, num_ids)
    if feats is not None:
        nf = feats.shape[0]
        xf = np.zeros((n, k, 2), np.float32)
        xf[:, :nf] = feats
        pfc = np.zeros((n, k, 2, 2), np.float32)
        pfc[:, :nf] = np.eye(2, dtype=np.float32) * 0.5
        table = np.full((num_ids,), -1, np.int32)
        table[:nf] = np.arange(nf)
        ens = ens._replace(
            xf=jnp.asarray(xf), pf=jnp.asarray(pfc),
            n_active=jnp.int32(nf), table=jnp.asarray(table),
        )
    return ens


def test_init_ensemble_uniform_weights():
    ens = pf.init_ensemble(10, 4, 12)
    w = pf.normalized_weights(ens)
    np.testing.assert_allclose(w, np.full(10, 0.1), rtol=1e-6)
    assert int(ens.n_active) == 0


def test_predict_propagates_pose_cov():
    ens = pf.init_ensemble(4, 2, 6)
    q = jnp.asarray(np.diag([0.09, 0.0003]).astype(np.float32))
    out = pf.predict(ens, 50.0, 0.1, q, 73.0, 0.01)
    # All particles identical; covariance = Gu Q Gu^T after one step from P=0.
    from conan_slam.models import motion
    gv, gu = motion.jacobians(jnp.zeros(3), 50.0, 0.1, 73.0, 0.01)
    expected = np.asarray(gu) @ np.asarray(q) @ np.asarray(gu).T
    np.testing.assert_allclose(out.pose_cov[0], expected, rtol=1e-4, atol=1e-8)
    assert not np.allclose(out.pose, 0.0)


def test_feature_update_reduces_uncertainty_and_matches_kf():
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    ens = _ens_with_features(n=3, feats=feats)
    zp, _, _ = sensor.observe(jnp.zeros(3), jnp.asarray(feats))
    obs = CompactObs(
        z=jnp.asarray(np.asarray(zp) + [[0.3, 0.01], [-0.2, 0.005]]),
        ids=jnp.asarray([0, 1], jnp.int32),
        mask=jnp.asarray([True, True]),
    )
    r = jnp.asarray(np.diag([0.01, 0.0003]).astype(np.float32))
    out = pf.feature_update(ens, obs, jnp.asarray([0, 1]), jnp.asarray([True, True]), r)

    # NumPy closed-form KF on feature 0 of particle 0.
    x0 = feats[0]
    p0 = np.eye(2, dtype=np.float32) * 0.5
    zp0, _, hf = sensor.observe(jnp.zeros(3), jnp.asarray(x0))
    hf = np.asarray(hf)
    v = np.asarray(obs.z[0]) - np.asarray(zp0)
    s = hf @ p0 @ hf.T + np.asarray(r)
    kk = p0 @ hf.T @ np.linalg.inv(s)
    np.testing.assert_allclose(out.xf[0, 0], x0 + kk @ v, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        out.pf[0, 0], (np.eye(2) - kk @ hf) @ p0, rtol=1e-3, atol=1e-4
    )
    # Untouched slots unchanged.
    np.testing.assert_allclose(out.xf[0, 2:], 0.0)


def test_add_new_features_assigns_shared_slots():
    ens = _ens_with_features(n=3, feats=np.asarray([[30.0, 10.0]], np.float32))
    obs = CompactObs(
        z=jnp.asarray([[50.0, 0.3], [80.0, -0.7]], jnp.float32),
        ids=jnp.asarray([5, 6], jnp.int32),
        mask=jnp.asarray([True, True]),
    )
    r = jnp.asarray(np.diag([0.01, 0.0003]).astype(np.float32))
    out = pf.add_new_features(ens, obs, jnp.asarray([True, True]), r)
    assert int(out.n_active) == 3
    assert int(out.table[5]) == 1 and int(out.table[6]) == 2
    xf_exp, _, gz = sensor.init_feature(jnp.zeros(3), obs.z)
    np.testing.assert_allclose(out.xf[1, 1:3], np.asarray(xf_exp), rtol=1e-4)
    pf_exp = np.einsum("nab,bc,ndc->nad", np.asarray(gz), np.asarray(r), np.asarray(gz))
    np.testing.assert_allclose(out.pf[1, 1:3], pf_exp, rtol=1e-3, atol=1e-6)


def test_sample_proposal_pulls_pose_towards_measurements():
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    n = 64
    ens = _ens_with_features(n=n, feats=feats)
    # Particles start at a perturbed pose with broad prior covariance; the
    # true pose is the origin and measurements are exact from the origin.
    ens = ens._replace(
        pose=jnp.tile(jnp.asarray([2.0, -1.5, 0.05]), (n, 1)),
        pose_cov=jnp.tile(jnp.eye(3) * jnp.asarray([4.0, 4.0, 0.01]), (n, 1, 1)),
    )
    zp, _, _ = sensor.observe(jnp.zeros(3), jnp.asarray(feats))
    obs = CompactObs(z=zp, ids=jnp.asarray([0, 1], jnp.int32),
                     mask=jnp.asarray([True, True]))
    r = jnp.asarray(np.diag([0.01, 0.0003]).astype(np.float32))
    out = pf.sample_proposal(
        ens, obs, jnp.asarray([0, 1]), jnp.asarray([True, True]), r,
        jax.random.PRNGKey(0),
    )
    # Fused/sampled poses should be much closer to the origin than the prior.
    d_before = np.linalg.norm([2.0, -1.5])
    d_after = np.linalg.norm(np.asarray(out.pose[:, :2]), axis=1).mean()
    assert d_after < 0.5 * d_before
    assert np.all(np.isfinite(np.asarray(out.log_w)))
    # Pose covariance zeroed after sampling (reference PF.cpp:537).
    np.testing.assert_allclose(out.pose_cov, 0.0)


def test_stratified_resample_statistics():
    key = jax.random.PRNGKey(1)
    w = jnp.asarray(np.asarray([0.5, 0.25, 0.125, 0.125], np.float32))
    counts = np.zeros(4)
    for i in range(200):
        idx = pf.stratified_indices(jax.random.fold_in(key, i), w, 4)
        counts += np.bincount(np.asarray(idx), minlength=4)
    frac = counts / counts.sum()
    np.testing.assert_allclose(frac, np.asarray(w), atol=0.05)


def test_systematic_resample_statistics_and_roughening():
    from conan_slam.filters.pf.resample import systematic_indices

    key = jax.random.PRNGKey(2)
    w = jnp.asarray(np.asarray([0.5, 0.25, 0.125, 0.125], np.float32))
    counts = np.zeros(4)
    for i in range(200):
        idx = systematic_indices(jax.random.fold_in(key, i), w, 4)
        counts += np.bincount(np.asarray(idx), minlength=4)
    frac = counts / counts.sum()
    np.testing.assert_allclose(frac, np.asarray(w), atol=0.05)
    # Systematic draws are sorted (single shared offset).
    idx = np.asarray(systematic_indices(key, w, 4))
    assert np.all(np.diff(idx) >= 0)

    # Roughening jitters resampled poses (heading stays wrapped) but leaves
    # the no-resample path untouched.
    ens = pf.init_ensemble(8, 2, 4)
    lw = np.full(8, -30.0, np.float32)
    lw[3] = 0.0
    spread = np.linspace(-3.0, 4.0, 8).astype(np.float32)
    ens = ens._replace(log_w=jnp.asarray(lw),
                       pose=jnp.stack([jnp.asarray(spread)] * 3, axis=1))
    out = pf.resample(ens, jax.random.PRNGKey(0), num_effective=6.0,
                      enabled=True, kind="systematic", roughening=0.05)
    pose = np.asarray(out.pose)
    # Dominant particle (index 3, pose 0.0) cloned everywhere, then jittered:
    # std = 0.05 * spread(7) * 8^(-1/3) ~ 0.18 — small but nonzero.
    assert not np.all(pose[:, 0] == 0.0)
    assert np.abs(pose[:, 0]).max() < 1.5
    assert np.all(np.abs(pose[:, 2]) <= np.pi + 1e-6)


def test_resample_triggers_on_degenerate_weights():
    ens = pf.init_ensemble(8, 2, 4)
    lw = np.full(8, -30.0, np.float32)
    lw[3] = 0.0   # one dominant particle
    marker = np.arange(8, dtype=np.float32)
    ens = ens._replace(log_w=jnp.asarray(lw),
                       pose=jnp.stack([jnp.asarray(marker)] * 3, axis=1))
    out = pf.resample(ens, jax.random.PRNGKey(0), num_effective=6.0, enabled=True)
    # Dominant particle cloned everywhere; weights reset.
    assert np.all(np.asarray(out.pose[:, 0]) == 3.0)
    np.testing.assert_allclose(pf.normalized_weights(out), np.full(8, 0.125), rtol=1e-5)
    # Below-threshold Neff path: no resample when Neff is high.
    ens_ok = ens._replace(log_w=jnp.zeros(8))
    out2 = pf.resample(ens_ok, jax.random.PRNGKey(0), num_effective=6.0, enabled=True)
    np.testing.assert_allclose(out2.pose, ens.pose)


@pytest.mark.slow
def test_e2e_pf_noise_free_tracks_truth():
    cfg = SlamConfig(
        switch_control_noise=False,
        switch_sensor_noise=False,
        switch_inflate_noise=False,
        num_particles=20,
    )
    world = default_world()
    carry, outs = run_pf_slam(world, cfg, jax.random.PRNGKey(0), n_steps=2000)
    valid = ~outs.done
    ate = metrics.ate_rmse(outs.x_true, outs.x_est, valid)
    assert float(ate) < 1.0, f"noise-free PF ATE too high: {float(ate)}"
    assert int(carry.ens.n_active) > 0


def test_sample_proposal_relinearized_path():
    """The reference-faithful iterated-fusion path must also run (it has no
    default-path coverage otherwise) and broadly agree with the batched one."""
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    n = 16
    ens = _ens_with_features(n=n, feats=feats)
    ens = ens._replace(
        pose=jnp.tile(jnp.asarray([1.0, -0.5, 0.02]), (n, 1)),
        pose_cov=jnp.tile(jnp.eye(3) * jnp.asarray([1.0, 1.0, 0.01]), (n, 1, 1)),
    )
    from conan_slam.models import sensor
    zp, _, _ = sensor.observe(jnp.zeros(3), jnp.asarray(feats))
    obs = CompactObs(z=zp, ids=jnp.asarray([0, 1], jnp.int32),
                     mask=jnp.asarray([True, True]))
    r = jnp.asarray(np.diag([0.01, 0.0003]).astype(np.float32))
    out_seq = pf.sample_proposal(ens, obs, jnp.asarray([0, 1]),
                                 jnp.asarray([True, True]), r,
                                 jax.random.PRNGKey(0), relinearize=True)
    out_bat = pf.sample_proposal(ens, obs, jnp.asarray([0, 1]),
                                 jnp.asarray([True, True]), r,
                                 jax.random.PRNGKey(0), relinearize=False)
    assert np.all(np.isfinite(np.asarray(out_seq.log_w)))
    # Same keys, nearly-linear problem: fused poses should be close.
    np.testing.assert_allclose(np.asarray(out_seq.pose), np.asarray(out_bat.pose),
                               atol=0.2)
