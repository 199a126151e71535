"""chip_smoke.py's pieces on the CPU: device checks, result line, nvidia-smi
parsing, the compile-cache helper, the ops comparisons at tiny widths and the
sharded comparison on four virtual devices.  The GPU itself is exercised by
the ``gpu``-marked test at the end, which skips here."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from conan_slam.utils import compile_cache  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 4},
    }


@pytest.mark.parametrize("text,cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4,
     [("NVIDIA H100 80GB HBM3", "500.00 W")] * 4),
])
def test_parse_gpu_line(text, cards):
    assert chip_smoke.parse_gpu_line(text) == cards


@pytest.mark.parametrize("text", ["", "no separator here\n"])
def test_parse_gpu_line_rejects_malformed(text):
    with pytest.raises(ValueError):
        chip_smoke.parse_gpu_line(text)


def test_compile_cache_env_set(monkeypatch, tmp_path):
    # The variable wins and nothing is set in code.
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("name,fn,args", [
    ("rank_update", chip_smoke.check_rank_update, (64, 10)),
    ("spd_inverse", chip_smoke.check_spd_inverse, (16,)),
    ("gating", chip_smoke.check_gating, (40, 8)),
    ("frame_update", chip_smoke.check_frame_update, (40, 8)),
    ("frame_step", chip_smoke.check_frame_step, (40, 8)),
])
def test_ops_comparisons_tiny(name, fn, args):
    c = fn(*args)
    assert c.ok, c.line()
    assert c.line().startswith("compare ")


def test_compare_sharded_on_four_virtual_devices():
    from conan_slam.config import SlamConfig
    from conan_slam.filters.ekf import init_state_with_map
    from conan_slam.sim.world import default_world

    world = default_world()
    state0 = init_state_with_map(world.landmarks, sigma0=1.0)
    pose_err, nis_err, frames = chip_smoke.compare_sharded(
        world, SlamConfig(max_obs=16), state0, jax.random.PRNGKey(0), 600, 4)
    assert frames > 50
    assert pose_err <= chip_smoke.SHARDED_POSE_TOL
    assert nis_err <= chip_smoke.SHARDED_NIS_TOL


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_and_prints_no_result_without_gpu(tmp_path, alone):
    # Here there is no GPU; run alone, the script also lacks the package.
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_ops_match_oracles_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        for c in (chip_smoke.check_rank_update(2304, 152),
                  chip_smoke.check_spd_inverse(128),
                  chip_smoke.check_gating(500, 64),
                  chip_smoke.check_frame_update(1024, 64),
                  chip_smoke.check_frame_step(1024, 64)):
            assert c.ok, c.line()
