"""Sim3 pose-graph (essential graph) optimization.

Replaces `Optimizer::OptimizeEssentialGraph` + g2o's
`types_seven_dof_expmap` (ref: corbslam_client/src/Optimizer.cc:840:
Sim3 vertices per keyframe, edges from loop closures + spanning tree +
strong covisibility, 20 LM iterations). Re-design: vertices are SoA
Sim3 arrays, edge residuals r_e = log(S_meas_ji * S_i * S_j^-1) with
Jacobians from forward-mode autodiff (vmapped per edge — 7x7 blocks), and
the normal equations solved MATRIX-FREE with block-Jacobi PCG, the same
pattern as optim/ba.py. No sparse-matrix assembly, no nMaxKFid-sized dense
arrays (the reference's vScw indexing bug class, SURVEY.md §7.3).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3
from .smallmat import chol_solve_factored, chol_unrolled, inv_spd_unrolled

_PREC = jax.lax.Precision.HIGHEST


class PoseGraph(NamedTuple):
    # Vertices: world->kf Sim3 (Scw), SoA.
    R: jnp.ndarray        # [N, 3, 3]
    t: jnp.ndarray        # [N, 3]
    s: jnp.ndarray        # [N]
    fixed: jnp.ndarray    # [N] bool (loop KF + invalid slots)
    # Edges with Sim3 measurements S_ji = S_j * S_i^-1 (at build time).
    e_i: jnp.ndarray      # [E] i32
    e_j: jnp.ndarray      # [E]
    mR: jnp.ndarray       # [E, 3, 3]
    mt: jnp.ndarray       # [E, 3]
    ms: jnp.ndarray       # [E]
    e_valid: jnp.ndarray  # [E]
    e_weight: jnp.ndarray # [E] information scale (loop edges can be heavier)


def edge_residual(Si, Sj, Sm):
    """r = log( Sm ∘ Si ∘ Sj^-1 ) in sim3 tangent [7]."""
    S = sim3.compose(Sm, sim3.compose(Si, sim3.inverse(Sj)))
    return sim3.log(S)


def _edge_residual_tangent(xi_i, xi_j, Si, Sj, Sm):
    Si2 = sim3.retract(Si, xi_i)
    Sj2 = sim3.retract(Sj, xi_j)
    return edge_residual(Si2, Sj2, Sm)


def linearize_edges(g: PoseGraph):
    """Residuals [E, 7] + Jacobians [E, 7, 7] w.r.t. both endpoint tangents."""
    Si = (g.R[g.e_i], g.t[g.e_i], g.s[g.e_i])
    Sj = (g.R[g.e_j], g.t[g.e_j], g.s[g.e_j])
    Sm = (g.mR, g.mt, g.ms)
    zero = jnp.zeros(7, jnp.float32)

    def one(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        f = lambda xi, xj: _edge_residual_tangent(
            xi, xj, (Ri, ti, si), (Rj, tj, sj), (Rm, tm, sm)
        )
        r = f(zero, zero)
        Ji = jax.jacfwd(f, argnums=0)(zero, zero)
        Jj = jax.jacfwd(f, argnums=1)(zero, zero)
        return r, Ji, Jj

    return jax.vmap(one)(
        Si[0], Si[1], Si[2], Sj[0], Sj[1], Sj[2], g.mR, g.mt, g.ms
    )


@partial(jax.jit, static_argnames=("n_iters", "cg_iters"))
def optimize(g: PoseGraph, n_iters: int = 20, cg_iters: int = 50, lam: float = 1e-6):
    """Gauss-Newton with fixed damping (the essential-graph problem starts
    near the optimum everywhere except around the loop, like the reference's
    20-iteration LM run)."""
    N = g.R.shape[0]
    free = (~g.fixed).astype(jnp.float32)

    def gn_iter(state, _):
        R, t, s = state
        gg = g._replace(R=R, t=t, s=s)
        r, Ji, Jj = linearize_edges(gg)
        w = (g.e_valid.astype(jnp.float32) * g.e_weight)[:, None]
        rw = r * w
        Ji_w = Ji * w[:, :, None]
        Jj_w = Jj * w[:, :, None]

        # Block-diagonal for damping + preconditioner.
        Hd = jax.ops.segment_sum(
            jnp.einsum("eri,erj->eij", Ji_w, Ji, precision=_PREC), g.e_i, N
        ) + jax.ops.segment_sum(
            jnp.einsum("eri,erj->eij", Jj_w, Jj, precision=_PREC), g.e_j, N
        )
        Hd = Hd + lam * jnp.eye(7) + 1e-8 * jnp.eye(7)
        Minv = inv_spd_unrolled(Hd + 1e-6 * jnp.eye(7), 7)

        b = -(
            jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Ji_w, r, precision=_PREC), g.e_i, N
            )
            + jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Jj_w, r, precision=_PREC), g.e_j, N
            )
        ) * free[:, None]

        def Hv(v):
            v = v * free[:, None]
            a = jnp.einsum("eri,ei->er", Ji, v[g.e_i], precision=_PREC) + jnp.einsum(
                "eri,ei->er", Jj, v[g.e_j], precision=_PREC
            )
            a = a * w
            out = jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Ji, a, precision=_PREC), g.e_i, N
            ) + jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Jj, a, precision=_PREC), g.e_j, N
            )
            out = out + (lam + 1e-8) * v
            return out * free[:, None]

        def precond(x):
            return jnp.einsum("nij,nj->ni", Minv, x, precision=_PREC) * free[:, None]

        x = jnp.zeros_like(b)
        r0 = b
        z0 = precond(r0)
        rz0 = jnp.sum(r0 * z0)

        def cg_body(stt, _):
            x, rr, p, rz = stt
            Ap = Hv(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz2 = jnp.sum(rr * z)
            beta = rz2 / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            return (x, rr, z + beta * p, rz2), None

        (dx, _, _, _), _ = jax.lax.scan(cg_body, (x, r0, z0, rz0), None, length=cg_iters)
        R2, t2, s2 = sim3.retract((R, t, s), dx)
        keep = g.fixed[:, None, None]
        R = jnp.where(keep, R, R2)
        t = jnp.where(g.fixed[:, None], t, t2)
        s = jnp.where(g.fixed, s, s2)
        cost = jnp.sum((r * r) * (w * w))
        return (R, t, s), cost

    (R, t, s), costs = jax.lax.scan(gn_iter, (g.R, g.t, g.s), None, length=n_iters)
    # Newton polar projection back onto SO(3) (see se3.orthonormalize_fast).
    I = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    for _ in range(2):
        R = 0.5 * jnp.matmul(
            R, 3.0 * I - jnp.matmul(jnp.swapaxes(R, -1, -2), R,
                                    precision=_PREC),
            precision=_PREC)
    return (R, t, s), costs
