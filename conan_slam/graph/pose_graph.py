"""SE(2) pose-graph optimisation for loop closure on long valet loops.

No reference analogue exists (the reference never revisits corrections to past
poses); scope is set by BASELINE.json config 4: "long valet loop with loop
closure + pose-graph relaxation".  Design is device-first throughout:

- static shapes: fixed node/edge capacities with validity masks;
- the sparse Gauss-Newton normal equations are never materialised — the
  Hessian-vector product is two gathers + two segment-sums over batched
  3x3 block algebra (elementwise, fused by XLA), wrapped in a fixed-iteration conjugate
  gradient inside ``lax.scan``;
- damped (Levenberg) iterations, gauge fixed by an anchor prior on node 0.

Edge model (standard SE(2) relative-pose factor):
    T_i^-1 T_j = (R(th_i)^T (t_j - t_i), th_j - th_i)
    r_e = t2v(T_i^-1 T_j) - z_e        (angle component wrapped)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conan_slam.core.geometry import wrap_angle
from conan_slam.core.linalg import PRECISION


class PoseGraph(NamedTuple):
    nodes: jax.Array       # (T, 3) pose estimates (x, y, theta)
    node_mask: jax.Array   # (T,) bool
    edges: jax.Array       # (E, 2) int32 (i, j) node indices
    meas: jax.Array        # (E, 3) measured relative pose in frame i
    info: jax.Array        # (E, 3, 3) information (inverse covariance)
    edge_mask: jax.Array   # (E,) bool


def relative_pose(pose_i, pose_j):
    """t2v(T_i^-1 T_j) for batched poses (..., 3)."""
    c = jnp.cos(pose_i[..., 2])
    s = jnp.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    return jnp.stack(
        [
            c * dx + s * dy,
            -s * dx + c * dy,
            wrap_angle(pose_j[..., 2] - pose_i[..., 2]),
        ],
        axis=-1,
    )


def _edge_residual_jacobians(nodes, edges, meas):
    """Residuals (E, 3) and Jacobian blocks A = dr/dx_i, B = dr/dx_j (E, 3, 3)."""
    pi = nodes[edges[:, 0]]
    pj = nodes[edges[:, 1]]
    c = jnp.cos(pi[:, 2])
    s = jnp.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]

    r = jnp.stack(
        [
            c * dx + s * dy - meas[:, 0],
            -s * dx + c * dy - meas[:, 1],
            wrap_angle(pj[:, 2] - pi[:, 2] - meas[:, 2]),
        ],
        axis=-1,
    )
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    # A = d r / d pose_i.
    a = jnp.stack(
        [
            jnp.stack([-c, -s, -s * dx + c * dy], axis=-1),
            jnp.stack([s, -c, -c * dx - s * dy], axis=-1),
            jnp.stack([zero, zero, -one], axis=-1),
        ],
        axis=-2,
    )
    # B = d r / d pose_j.
    b = jnp.stack(
        [
            jnp.stack([c, s, zero], axis=-1),
            jnp.stack([-s, c, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return r, a, b


def graph_error(g: PoseGraph) -> jax.Array:
    """Total chi^2 = sum_e r^T Omega r over valid edges."""
    r, _, _ = _edge_residual_jacobians(g.nodes, g.edges, g.meas)
    chi = jnp.einsum("ea,eab,eb->e", r, g.info, r, precision=PRECISION)
    return jnp.sum(jnp.where(g.edge_mask, chi, 0.0))


def _incidence_cg(i, j, w, rhs, n, cg_iterations, anchor_weight, damping=1e-6):
    """CG solve of the weighted graph-Laplacian system L x = rhs.

    L = sum_e w_e (e_j - e_i)(e_j - e_i)^T + anchor at node 0 + damping.
    ``rhs``/result are (N,) or (N, 2); the workhorse of the chordal init.
    """

    def lap(v):
        dv = (v[j] - v[i]) * (w[:, None] if v.ndim == 2 else w)
        out = jnp.zeros_like(v)
        out = out.at[i].add(-dv)
        out = out.at[j].add(dv)
        out = out + damping * v
        return out.at[0].add(anchor_weight * v[0])

    def cg_step(carry, _):
        x, res, p, rs = carry
        ap = lap(p)
        denom = jnp.sum(p * ap)
        alpha = jnp.where(denom > 0, rs / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        res = res - alpha * ap
        rs_new = jnp.sum(res * res)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = res + beta * p
        return (x, res, p, rs_new), None

    (x, _, _, _), _ = jax.lax.scan(
        cg_step, (jnp.zeros_like(rhs), rhs, rhs, jnp.sum(rhs * rhs)),
        None, length=cg_iterations,
    )
    return x


def chordal_initialize(g: PoseGraph, *, cg_iterations: int | None = None) -> PoseGraph:
    """Two-stage linear initialisation (SE(2) chordal/rotation-first).

    Gauss-Newton on a badly drifted chain folds into local minima: the
    nonlinearity lives entirely in the headings.  Stage A solves the LINEAR
    least-squares heading-correction problem over all edges (odometry +
    closures; residuals wrapped at the current estimate, which resolves the
    2*pi ambiguity as long as per-edge errors are < pi).  Stage B solves the
    exactly-linear position problem given headings.  The result lands in the
    global basin for GN to polish.
    """
    t = g.nodes.shape[0]
    if cg_iterations is None:
        cg_iterations = max(60, t)
    i, j = g.edges[:, 0], g.edges[:, 1]
    em = g.edge_mask.astype(g.nodes.dtype)
    anchor_weight = 1e6

    # --- stage A: headings ---
    theta = g.nodes[:, 2]
    w_th = g.info[:, 2, 2] * em
    r_th = wrap_angle(theta[j] - theta[i] - g.meas[:, 2]) * em
    rhs = jnp.zeros((t,), g.nodes.dtype)
    rhs = rhs.at[i].add(w_th * r_th)
    rhs = rhs.at[j].add(-w_th * r_th)
    dth = _incidence_cg(i, j, w_th, rhs, t, cg_iterations, anchor_weight)
    theta = theta + dth

    # --- stage B: positions (linear given headings) ---
    c = jnp.cos(theta[i])
    s = jnp.sin(theta[i])
    d_e = jnp.stack(
        [c * g.meas[:, 0] - s * g.meas[:, 1],
         s * g.meas[:, 0] + c * g.meas[:, 1]],
        axis=-1,
    )
    w_xy = g.info[:, 0, 0] * em
    pos = g.nodes[:, :2]
    r_xy = (pos[j] - pos[i] - d_e) * em[:, None]
    rhs2 = jnp.zeros((t, 2), g.nodes.dtype)
    rhs2 = rhs2.at[i].add(w_xy[:, None] * r_xy)
    rhs2 = rhs2.at[j].add(-(w_xy[:, None] * r_xy))
    dpos = _incidence_cg(i, j, w_xy, rhs2, t, cg_iterations, anchor_weight)

    nodes = jnp.concatenate([pos + dpos, wrap_angle(theta)[:, None]], axis=-1)
    nodes = jnp.where(g.node_mask[:, None], nodes, g.nodes)
    return g._replace(nodes=nodes)


def optimize(
    g: PoseGraph,
    *,
    iterations: int = 10,
    cg_iterations: int = 50,
    damping: float = 1e-3,
    anchor_weight: float = 1e6,
    chordal_init: bool = False,
) -> PoseGraph:
    """Damped Gauss-Newton with matrix-free block-Jacobi-preconditioned CG.

    The anchor prior (information ``anchor_weight * I`` on node 0's current
    error against its initial value) removes the global SE(2) gauge freedom.
    ``chordal_init`` runs the two-stage linear initialisation first —
    required for badly drifted initial chains (dead reckoning), harmless
    otherwise.  Three passes: the heading stage's residual wrapping updates
    between passes (measured: pass 1 lands in the basin, pass 2 tightens,
    pass 3 is a no-op safety margin).
    """
    if chordal_init:
        for _ in range(3):
            g = chordal_initialize(g)
    t = g.nodes.shape[0]
    anchor0 = g.nodes[0]

    def hvp(nodes, a, b, omega_a, omega_b, v):
        """(J^T Omega J + lambda I + anchor) v without materialising J."""
        i, j = g.edges[:, 0], g.edges[:, 1]
        vi = v[i]
        vj = v[j]
        # J v per edge: A v_i + B v_j (E, 3).
        jv = jnp.einsum(
            "eab,eb->ea", a, vi, precision=PRECISION
        ) + jnp.einsum("eab,eb->ea", b, vj, precision=PRECISION)
        jv = jnp.where(g.edge_mask[:, None], jv, 0.0)
        # J^T Omega (Jv): scatter A^T w to i, B^T w to j.
        w = jnp.einsum("eab,eb->ea", omega_a, jv, precision=PRECISION)   # here omega_a = Omega
        out = jnp.zeros_like(v)
        out = out.at[i].add(jnp.einsum("eba,eb->ea", a, w, precision=PRECISION))
        out = out.at[j].add(jnp.einsum("eba,eb->ea", b, w, precision=PRECISION))
        out = out + damping * v
        out = out.at[0].add(anchor_weight * v[0])
        return out

    def gn_step(nodes, _):
        from conan_slam.core.linalg import inv3

        r, a, b = _edge_residual_jacobians(nodes, g.edges, g.meas)
        omega = g.info
        omega_r = jnp.einsum("eab,eb->ea", omega, r, precision=PRECISION)
        omega_r = jnp.where(g.edge_mask[:, None], omega_r, 0.0)
        i, j = g.edges[:, 0], g.edges[:, 1]
        grad = jnp.zeros_like(nodes)
        grad = grad.at[i].add(jnp.einsum("eba,eb->ea", a, omega_r, precision=PRECISION))
        grad = grad.at[j].add(jnp.einsum("eba,eb->ea", b, omega_r, precision=PRECISION))
        grad = grad.at[0].add(anchor_weight * (nodes[0] - anchor0))
        rhs = -grad

        # Block-Jacobi preconditioner: the (3, 3) node-diagonal blocks of
        # J^T Omega J + lambda I (+ anchor).  Mixed metre/radian information
        # scales condition the unpreconditioned system terribly — with the
        # preconditioner the CG iteration count is set by chain length, not
        # by unit heterogeneity.
        em = g.edge_mask[:, None, None].astype(nodes.dtype)
        ata = em * jnp.einsum("eba,ebc,ecd->ead", a, omega, a, precision=PRECISION)
        btb = em * jnp.einsum("eba,ebc,ecd->ead", b, omega, b, precision=PRECISION)
        diag = jnp.zeros((t, 3, 3), nodes.dtype)
        diag = diag.at[i].add(ata)
        diag = diag.at[j].add(btb)
        diag = diag + damping * jnp.eye(3, dtype=nodes.dtype)
        diag = diag.at[0].add(anchor_weight * jnp.eye(3, dtype=nodes.dtype))
        minv = inv3(diag)                                   # (T, 3, 3)

        def prec(v):
            return jnp.einsum("tab,tb->ta", minv, v, precision=PRECISION)

        # Fixed-iteration preconditioned CG on (J^T Omega J + lambda I) dx = rhs.
        def cg_step(carry, _):
            x, res, p, rz = carry
            ap = hvp(nodes, a, b, omega, omega, p)
            denom = jnp.sum(p * ap)
            alpha = jnp.where(denom > 0, rz / jnp.maximum(denom, 1e-30), 0.0)
            x = x + alpha * p
            res = res - alpha * ap
            z = prec(res)
            rz_new = jnp.sum(res * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (x, res, p, rz_new), None

        x0 = jnp.zeros_like(nodes)
        z0 = prec(rhs)
        (dx, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, rhs, z0, jnp.sum(rhs * z0)), None, length=cg_iterations
        )
        nodes_new = nodes + jnp.where(g.node_mask[:, None], dx, 0.0)
        nodes_new = nodes_new.at[:, 2].set(wrap_angle(nodes_new[:, 2]))
        return nodes_new, None

    nodes, _ = jax.lax.scan(gn_step, g.nodes, None, length=iterations)
    return g._replace(nodes=nodes)


def detect_loop_closures(
    nodes,
    node_mask,
    *,
    max_candidates: int,
    radius: float,
    min_index_gap: int,
):
    """Proximity-based loop-closure candidates on a keyframe trajectory.

    Returns (pairs (C, 2) int32, mask (C,)): node pairs whose positions fall
    within ``radius`` but whose indices are at least ``min_index_gap`` apart —
    the classic revisit signature.  Greedy earliest-pair selection via top-k
    on a dense masked score (static shapes; T^2 pairs is fine at keyframe
    counts, which are O(trajectory / keyframe_stride)).
    """
    t = nodes.shape[0]
    pos = nodes[:, :2]
    d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    ii = jnp.arange(t)
    gap = jnp.abs(ii[:, None] - ii[None, :])
    valid = (
        (d2 < radius**2)
        & (gap >= min_index_gap)
        & node_mask[:, None]
        & node_mask[None, :]
        & (ii[:, None] < ii[None, :])
    )
    # Prefer the closest pairs.
    score = jnp.where(valid, -d2, -jnp.inf).reshape(-1)
    top, idx = jax.lax.top_k(score, max_candidates)
    pairs = jnp.stack([idx // t, idx % t], axis=-1).astype(jnp.int32)
    return pairs, jnp.isfinite(top)
