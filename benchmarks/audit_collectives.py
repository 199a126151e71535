"""HLO-level audit of per-frame collective bytes in the sharded EKF.

parallel.dist_ekf claims O(m * Dp) wire cost per measurement update
(dist_ekf.py module docstring) versus the O(Dp^2) resident covariance.
This script compiles one full distributed frame step (predict + heading +
batched update + augment) on an 8-device virtual CPU mesh, walks the
optimized HLO for communication ops (all-gather / all-reduce / permute /
all-to-all), and prints a per-collective byte table plus the O(m * Dp)
check — evidence for the scaling claim from the compiled program alone,
without the devices.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python benchmarks/audit_collectives.py
(or plain `python` — it forces the CPU platform itself).
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_N_DEV = int(os.environ.get("AUDIT_DEVICES", "8"))
_N_LM = int(os.environ.get("AUDIT_LANDMARKS", "512"))
_N_OBS = int(os.environ.get("AUDIT_OBS", "32"))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={_N_DEV}"
)

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "pred": 1,
                "f64": 8, "s8": 1, "u8": 1, "s64": 8, "u64": 8,
                "s16": 2, "u16": 2}

_COLLECTIVES = ("all-gather", "all-reduce", "collective-permute", "all-to-all",
                "reduce-scatter")


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one 'f32[8,136]{...}' HLO shape string."""
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for p in dims.split(","):
        if p:
            n *= int(p)
    return n * _DTYPE_BYTES.get(dt, 4)


def audit_hlo(hlo: str):
    """(op kind, output shape, bytes) for every collective in optimized HLO."""
    rows = []
    for line in hlo.splitlines():
        line = line.strip()
        m = re.search(r"=\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*))\s+"
                      r"(all-gather|all-reduce|collective-permute|all-to-all|"
                      r"reduce-scatter)", line)
        if not m:
            continue
        shape_str, kind = m.groups()
        shapes = re.findall(r"[a-z0-9]+\[[0-9,]*\]", shape_str)
        nbytes = sum(_shape_bytes(s) for s in shapes)
        rows.append((kind, shape_str.split("{")[0], nbytes))
    return rows


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from conan_slam.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from conan_slam.config import SlamConfig
    from conan_slam.filters import ekf as ekf_mod
    from conan_slam.parallel import dist_ekf
    from conan_slam.parallel.dist_runner import dist_ekf_frame_step, DistEKFCarry
    from conan_slam.parallel.mesh import STATE_AXIS, make_mesh
    from conan_slam.runner.loop import make_noise
    from conan_slam.sim.steering import init_steer_state
    from conan_slam.sim.world import default_world

    assert len(jax.devices()) >= _N_DEV, jax.devices()
    mesh = make_mesh({STATE_AXIS: _N_DEV})
    cfg = SlamConfig(max_landmarks=_N_LM, max_obs=_N_OBS,
                     dist_gain_wire=os.environ.get("AUDIT_GAIN_WIRE", "f32"))
    world = default_world()
    if _N_LM > world.num_landmarks:
        # Large-map audits need enough world landmarks to fill the obs buffer.
        from conan_slam.sim.world import random_world
        world = random_world(jax.random.PRNGKey(3), _N_LM)._replace(
            waypoints=world.waypoints
        )
    noise = make_noise(cfg, "ekf")
    state0 = ekf_mod.init_state(cfg.max_landmarks, world.num_landmarks)
    xs, ps = dist_ekf.shard_state(mesh, state0.x, state0.p)
    dp = xs.shape[0]
    nz = min(world.num_landmarks, cfg.max_observations())
    m = 2 * nz

    carry = DistEKFCarry(
        steer=init_steer_state(cfg.number_loops),
        x_true=jnp.zeros((3,), jnp.float32),
        x=xs, p=ps,
        n_active=state0.n_active, table=state0.table,
        key=jax.random.PRNGKey(0),
    )

    import functools
    step = functools.partial(
        dist_ekf_frame_step, cfg=cfg, world=world, noise=noise, mesh=mesh
    )
    lowered = jax.jit(lambda c: step(c, None)).lower(carry)
    hlo = lowered.compile().as_text()

    rows = audit_hlo(hlo)
    total = sum(r[2] for r in rows)
    print(f"# Collective audit: one dist_ekf frame step "
          f"(Dp={dp}, m={m}, mesh={_N_DEV}x state)")
    print(f"| kind | output shape | bytes |")
    print(f"|---|---|---|")
    agg = {}
    for kind, shape, nbytes in rows:
        print(f"| {kind} | `{shape}` | {nbytes:,} |")
        agg[kind] = agg.get(kind, 0) + nbytes
    print(f"| **total** | | **{total:,}** |")
    for k, v in sorted(agg.items()):
        print(f"#  {k}: {v:,} B")

    # The claim: per-frame collective bytes are O(m * Dp) + O(interval * Dp)
    # (gain strip + per-substep heading column strips + pose broadcasts),
    # NOT O(Dp^2).  Allow a generous constant; fail if quadratic-scale
    # traffic appears.
    interval = cfg.observe_interval
    bound = 4 * (4 * m * dp + 4 * interval * dp * 4 + m * m * 16 + 4096 * 64)
    print(f"# O(m*Dp) bound check: total={total:,} <= bound={bound:,}: "
          f"{total <= bound}")
    quad = 4 * dp * dp // 8
    print(f"# AUDIT_RESULT total_bytes={total} dp={dp} m={m} ndev={_N_DEV}")
    assert total <= bound, (total, bound)
    assert total < quad, f"collective bytes {total} ~ O(Dp^2/8) {quad}"
    log("audit_collectives: PASS")


if __name__ == "__main__":
    main()
