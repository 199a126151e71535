"""Unit tests for motion/sensor models: analytic Jacobians vs finite
differences, inverse-model consistency (SURVEY.md section 7.2 layer 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_slam.core import geometry
from conan_slam.core.linalg import inv2, inv3, mvn_logpdf, safe_cholesky
from conan_slam.models import motion, sensor


def test_wrap_angle_range():
    angles = jnp.linspace(-20.0, 20.0, 401)
    wrapped = geometry.wrap_angle(angles)
    assert jnp.all(wrapped >= -jnp.pi) and jnp.all(wrapped < jnp.pi)
    # Equivalent modulo 2*pi.
    np.testing.assert_allclose(
        np.cos(np.asarray(angles)), np.cos(np.asarray(wrapped)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.sin(np.asarray(angles)), np.sin(np.asarray(wrapped)), atol=1e-5
    )


def test_motion_step_matches_reference_formula():
    pose = jnp.asarray([10.0, -5.0, 0.3])
    v, swa, wb, dt = 83.33, 0.1, 73.0, 0.01
    new = motion.step(pose, v, swa, wb, dt)
    assert np.isclose(new[0], 10.0 + v * dt * np.cos(swa + 0.3), atol=1e-5)
    assert np.isclose(new[1], -5.0 + v * dt * np.sin(swa + 0.3), atol=1e-5)
    assert np.isclose(new[2], 0.3 + v * dt * np.sin(swa) / wb, atol=1e-5)


def test_motion_jacobians_vs_autodiff():
    pose = jnp.asarray([1.0, 2.0, 0.7])
    v, swa, wb, dt = 50.0, 0.2, 73.0, 0.01
    gv, gu = motion.jacobians(pose, v, swa, wb, dt)
    gv_ad = jax.jacfwd(lambda p: motion.step(p, v, swa, wb, dt))(pose)
    gu_ad = jax.jacfwd(lambda u: motion.step(pose, u[0], u[1], wb, dt))(
        jnp.asarray([v, swa])
    )
    np.testing.assert_allclose(gv, gv_ad, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gu, gu_ad, rtol=1e-4, atol=1e-5)


def test_sensor_jacobians_vs_autodiff():
    pose = jnp.asarray([1.0, 2.0, 0.5])
    xf = jnp.asarray([[30.0, -14.0], [-7.0, 22.0], [100.0, 3.0]])
    zp, hv, hf = sensor.observe(pose, xf)

    def z_of_pose(p, f):
        d = f - p[:2]
        return jnp.asarray(
            [jnp.sqrt(jnp.sum(d * d)), jnp.arctan2(d[1], d[0]) - p[2]]
        )

    for i in range(xf.shape[0]):
        hv_ad = jax.jacfwd(z_of_pose, argnums=0)(pose, xf[i])
        hf_ad = jax.jacfwd(z_of_pose, argnums=1)(pose, xf[i])
        np.testing.assert_allclose(hv[i], hv_ad, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hf[i], hf_ad, rtol=1e-4, atol=1e-5)


def test_init_feature_roundtrip_and_jacobians():
    pose = jnp.asarray([3.0, -1.0, 0.8])
    z = jnp.asarray([[120.0, 0.4], [55.0, -1.2]])
    xf, gv, gz = sensor.init_feature(pose, z)
    # Round trip: observing the initialised feature reproduces z.
    zp, _, _ = sensor.observe(pose, xf)
    np.testing.assert_allclose(zp[:, 0], z[:, 0], rtol=1e-4)
    np.testing.assert_allclose(
        geometry.wrap_angle(zp[:, 1] - z[:, 1]), 0.0, atol=1e-5
    )
    for i in range(z.shape[0]):
        gv_ad = jax.jacfwd(lambda p: sensor.init_feature(p, z[i])[0])(pose)
        gz_ad = jax.jacfwd(lambda zz: sensor.init_feature(pose, zz)[0])(z[i])
        np.testing.assert_allclose(gv[i], gv_ad, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gz[i], gz_ad, rtol=1e-4, atol=1e-4)


def test_small_inverses():
    rng = np.random.default_rng(0)
    a2 = rng.normal(size=(5, 2, 2)).astype(np.float32)
    a2 = a2 @ a2.transpose(0, 2, 1) + 0.5 * np.eye(2, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(inv2(jnp.asarray(a2))), np.linalg.inv(a2), rtol=2e-3, atol=2e-4
    )
    a3 = rng.normal(size=(4, 3, 3)).astype(np.float32)
    a3 = a3 @ a3.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(inv3(jnp.asarray(a3))), np.linalg.inv(a3), rtol=2e-3, atol=2e-4
    )


def test_safe_cholesky_guard():
    good = jnp.asarray([[4.0, 0.0], [0.0, 9.0]])
    np.testing.assert_allclose(
        safe_cholesky(good), [[2.0, 0.0], [0.0, 3.0]], atol=1e-6
    )
    # Indefinite input -> zero factor, not NaN (reference slam.h:431-434).
    bad = jnp.asarray([[1.0, 0.0], [0.0, -1.0]])
    assert jnp.all(safe_cholesky(bad) == 0.0)


def test_mvn_logpdf_matches_scipy_formula():
    rng = np.random.default_rng(1)
    s = rng.normal(size=(2, 2)).astype(np.float32)
    s = s @ s.T + np.eye(2, dtype=np.float32)
    v = np.asarray([0.3, -0.7], np.float32)
    expected = -0.5 * (
        v @ np.linalg.solve(s, v) + np.log(np.linalg.det(s)) + 2 * np.log(2 * np.pi)
    )
    got = mvn_logpdf(jnp.asarray(v), jnp.asarray(s))
    np.testing.assert_allclose(got, expected, rtol=1e-4)


def test_sample_mvn_statistics():
    from conan_slam.core.linalg import sample_mvn
    mean = jnp.asarray([1.0, -2.0])
    cov = jnp.asarray([[2.0, 0.6], [0.6, 0.5]])
    xs = sample_mvn(jax.random.PRNGKey(0), mean, cov, num_samples=20000)
    np.testing.assert_allclose(xs.mean(axis=0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(np.asarray(xs).T), cov, atol=0.08)


def test_closed_form_chol3_and_logpdfs():
    from conan_slam.core.linalg import chol3, mvn_logpdf2, mvn_logpdf3, mvn_logpdf
    rng = np.random.default_rng(5)
    a = rng.normal(size=(7, 3, 3)).astype(np.float32)
    s3 = a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32) * 0.3
    c = np.asarray(chol3(jnp.asarray(s3)))
    np.testing.assert_allclose(c @ c.transpose(0, 2, 1), s3, rtol=1e-4, atol=1e-4)
    # Non-PSD -> zeros.
    bad = np.eye(3, dtype=np.float32); bad[2, 2] = -1.0
    assert np.all(np.asarray(chol3(jnp.asarray(bad))) == 0.0)

    v3 = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(mvn_logpdf3(jnp.asarray(v3), jnp.asarray(s3))),
        np.asarray(mvn_logpdf(jnp.asarray(v3), jnp.asarray(s3))),
        rtol=1e-4, atol=1e-4,
    )
    b = rng.normal(size=(7, 2, 2)).astype(np.float32)
    s2 = b @ b.transpose(0, 2, 1) + np.eye(2, dtype=np.float32) * 0.3
    v2 = rng.normal(size=(7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(mvn_logpdf2(jnp.asarray(v2), jnp.asarray(s2))),
        np.asarray(mvn_logpdf(jnp.asarray(v2), jnp.asarray(s2))),
        rtol=1e-4, atol=1e-4,
    )
