"""Native C++ baseline tests (ctypes surface, CPU-only)."""

import numpy as np
import pytest

from conan_slam.sim.world import default_world


@pytest.fixture(scope="module")
def world_np():
    w = default_world()
    return np.asarray(w.landmarks), np.asarray(w.waypoints)


def _run(lm, wp, **kw):
    from conan_slam.native import run_ekf_baseline

    try:
        return run_ekf_baseline(lm, wp, 25_000, **kw)
    except OSError as e:                       # no toolchain in this env
        pytest.skip(f"native lib unavailable: {e}")


def test_native_gated_matches_table_association_on_canonical_world(world_np):
    """The defect-fixed gated-NN path (slam_baseline.cpp::associate_gated,
    reference EKF.cpp:235-326 with SURVEY defect 4 fixed) must reach the
    same accuracy as ground-truth table association on the canonical world —
    the same property the JAX path's gated tests assert."""
    lm, wp = world_np
    table = _run(lm, wp, seed=3, with_noise=True, opt=True)
    gated = _run(lm, wp, seed=3, with_noise=True, opt=True,
                 gated=True, max_obs=64)
    assert table.steps == gated.steps
    assert gated.ate_rmse < 1.0, gated.ate_rmse
    # Same workload, same RNG stream: gated should land within 25% or 5 cm
    # of the table-association ATE (association is unambiguous on this world).
    assert abs(gated.ate_rmse - table.ate_rmse) < max(
        0.25 * table.ate_rmse, 0.05
    ), (gated.ate_rmse, table.ate_rmse)


def test_native_gated_noise_free_tracks_truth(world_np):
    """Noise-free gated run must track truth to numerical precision
    (SURVEY section 4's implicit correctness oracle)."""
    lm, wp = world_np
    res = _run(lm, wp, seed=0, with_noise=False, opt=True,
               gated=True, max_obs=64)
    assert res.ate_rmse < 0.01, res.ate_rmse
