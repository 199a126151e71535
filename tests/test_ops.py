"""The frame's linear algebra (ops/, filters.ekf update and gating) against
float64 NumPy oracles.  The oracles live in chip_smoke.py, which runs the
same comparisons on the GPU at real widths."""

import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from conan_slam.filters import ekf  # noqa: E402
from conan_slam.filters.common import CompactObs  # noqa: E402
from conan_slam.ops.spd_inverse import spd_inverse  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("d,r", [(64, 10), (128, 30), (130, 7), (256, 24)])
def test_rank_update_matches_f64(d, r):
    c = chip_smoke.check_rank_update(d, r, seed=d + r)
    assert c.ok, c.line()


@pytest.mark.parametrize("m", [16, 60, 128])
def test_spd_inverse_matches_f64(m):
    c = chip_smoke.check_spd_inverse(m, seed=m)
    assert c.ok, c.line()


@pytest.mark.parametrize("kind", ["nan", "indefinite"])
def test_spd_inverse_zero_on_failure(kind):
    # Reference degrade-don't-crash contract (slam.h:431-434): a failed
    # factorisation yields zeros, never NaN.
    if kind == "nan":
        s = np.full((8, 8), np.nan, np.float32)
    else:
        s = np.diag(np.asarray([1.0, -1.0] * 4, np.float32))
    out = np.asarray(spd_inverse(jnp.asarray(s)))
    np.testing.assert_array_equal(out, np.zeros((8, 8), np.float32))


def _gating_problem(virtual, masked, seed=51):
    state, z, ids, mask, vmat, bmat, r = chip_smoke._frame_problem(
        87, 12, 10, seed)
    state = state._replace(n_active=jnp.int32(82))      # last 5 inactive
    z = z.copy()
    z[-1] = [4000.0, 1.0]                               # far away: new
    if not masked:
        mask = np.ones_like(mask)
    if not virtual:
        vmat, bmat = np.zeros_like(vmat), np.zeros_like(bmat)
    return state, z, ids, mask, vmat, bmat, r


@pytest.mark.parametrize("virtual", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_associate_gated_matches_f64(virtual, masked):
    state, z, ids, mask, vmat, bmat, r = _gating_problem(virtual, masked)
    obs = CompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids),
                     mask=jnp.asarray(mask))
    vm, bm = (jnp.asarray(vmat), jnp.asarray(bmat)) if virtual else (None, None)
    got = ekf.associate_gated(state, obs, jnp.asarray(r), 50.0, 1000.0, vm, bm)
    known, best, new, margin = chip_smoke.gating_oracle(
        state.x, state.p, vmat, bmat, 82, z, mask, r, 50.0, 1000.0)
    assert margin > 1e-4
    np.testing.assert_array_equal(np.asarray(got.known_mask), known)
    np.testing.assert_array_equal(np.asarray(got.new_mask), new)
    np.testing.assert_array_equal(np.asarray(got.slots)[known], best[known])
    assert new[-1] and known.sum() >= 6


@pytest.mark.parametrize("masked", [False, True])
def test_fused_frame_update_matches_f64(masked):
    state, z, ids, mask, vmat, bmat, r = chip_smoke._frame_problem(
        40, 8, 12, seed=9)
    if not masked:
        mask = np.ones_like(mask)
    obs = CompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids),
                     mask=jnp.asarray(mask))
    got, nis = ekf.fused_frame_update(
        state, jnp.asarray(vmat), jnp.asarray(bmat), obs, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(r), return_nis=True)
    x_ref, p_ref, nis_ref = chip_smoke.frame_update_oracle(
        state.x, state.p, vmat, bmat, z, ids, mask, r)
    kappa = chip_smoke._innovation_kappa(state.x, state.p, vmat, bmat, ids,
                                         mask, r)
    c = chip_smoke._frame_comparison(
        "fused_frame_update", 16, kappa, z, r, x_ref,
        chip_smoke._errs(got.x, got.p, nis, x_ref, p_ref, nis_ref))
    assert c.ok, c.line()


def test_fused_frame_update_all_masked_is_factor_only():
    # No associated measurement: the frame degenerates to the factored
    # correction alone (P + V B V^T), mean unchanged.
    state, z, ids, mask, vmat, bmat, r = chip_smoke._frame_problem(
        40, 8, 12, seed=17)
    mask = np.zeros_like(mask)
    obs = CompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids),
                     mask=jnp.asarray(mask))
    out, nis = ekf.fused_frame_update(
        state, jnp.asarray(vmat), jnp.asarray(bmat), obs, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(r), return_nis=True)
    ref_p = np.asarray(state.p, np.float64) + vmat.astype(np.float64) @ (
        bmat.astype(np.float64) @ vmat.T.astype(np.float64))
    # (the heading is re-wrapped, which may move it by one ulp)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(state.x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.p), ref_p, rtol=1e-5, atol=1e-6)
    assert float(nis) == 0.0


_S = 6
_WB, _DT, _SIG_H = 73.0, 0.01, 0.01 * np.pi / 180


def _controls(seed):
    rng = np.random.default_rng(seed)
    vns = (83.33 + rng.normal(size=_S) * 0.3).astype(np.float32)
    swans = (rng.normal(size=_S) * 0.05).astype(np.float32)
    phis = (0.3 + np.cumsum(rng.normal(size=_S)) * 0.002).astype(np.float32)
    active = np.array([1, 1, 1, 1, 1, 0], bool)
    q = np.diag([0.6**2, (2.0 * np.pi / 180) ** 2]).astype(np.float32)
    return vns, swans, phis, active, q


@pytest.mark.parametrize("seed", [3, 29])
def test_fused_frame_step_matches_f64(seed):
    c = chip_smoke.check_frame_step(40, 8, seed=seed)
    assert c.ok, c.line()


def test_fused_frame_step_all_masked_is_factor_only():
    # No associated measurement: the frame step is the S predict+heading
    # sub-steps alone (float64 sequential oracle), with zero NIS.
    state, z, ids, mask, _, _, r = chip_smoke._frame_problem(40, 8, 12, seed=43)
    vns, swans, phis, active, q = _controls(43)
    mask = np.zeros_like(mask)
    obs = CompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids),
                     mask=jnp.asarray(mask))
    out, trace, nis = ekf.fused_frame_step(
        state, jnp.asarray(vns), jnp.asarray(swans), jnp.asarray(phis),
        jnp.asarray(active), jnp.asarray(q), obs, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(r), _WB, _DT, _SIG_H, True)
    x_ref, p_ref, trace_ref = chip_smoke.predict_heading_oracle(
        state.x, state.p, vns, swans, phis, active, q, _WB, _DT, _SIG_H)
    np.testing.assert_allclose(np.asarray(out.x), x_ref, rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(trace), trace_ref, rtol=0, atol=2e-3)
    scale = np.max(np.abs(p_ref))
    assert np.max(np.abs(np.asarray(out.p) - p_ref)) / scale < 1e-5
    assert float(nis) == 0.0


def test_fused_frame_step_matches_sequential_jnp_path():
    # The whole-frame step equals S x (predict + observe_heading) followed by
    # the Cholesky-form batch_update — the same frame through the
    # reference-shaped per-step code.
    state, z, ids, mask, _, _, r = chip_smoke._frame_problem(40, 8, 12, seed=61)
    vns, swans, phis, active, q = _controls(61)
    obs = CompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids),
                     mask=jnp.asarray(mask))
    args = (jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(r))
    with jax.default_matmul_precision("highest"):
        out, trace, _ = ekf.fused_frame_step(
            state, jnp.asarray(vns), jnp.asarray(swans), jnp.asarray(phis),
            jnp.asarray(active), jnp.asarray(q), obs, *args,
            _WB, _DT, _SIG_H, True)
        seq = state
        seq_trace = []
        for k in range(_S):
            if active[k]:
                seq = ekf.predict(seq, vns[k], swans[k], jnp.asarray(q), _WB, _DT)
                seq = ekf.observe_heading(seq, phis[k], _SIG_H)
            seq_trace.append(np.asarray(seq.x[:3]))
        seq = ekf.batch_update(seq, obs, *args)
    np.testing.assert_allclose(np.asarray(trace), np.stack(seq_trace),
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(seq.x),
                               rtol=0, atol=5e-3)
    p_ref = np.asarray(seq.p)
    assert np.max(np.abs(np.asarray(out.p) - p_ref)) / np.max(np.abs(p_ref)) < 1e-4


def test_no_module_branches_on_the_backend():
    # The package is plain JAX for the GPU: no Pallas import for another
    # accelerator and no branch on a backend name anywhere under conan_slam/.
    banned = ("pallas.tpu", "pallas import tpu", "pltpu", '"tpu"', "'tpu'",
              "default_backend()")
    offenders = [
        f"{path.relative_to(REPO)}: {word}"
        for path in sorted((REPO / "conan_slam").rglob("*.py"))
        for word in banned
        if word in path.read_text()
    ]
    assert not offenders, offenders
