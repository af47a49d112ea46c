"""Bundle adjustment: Schur-complement Levenberg-Marquardt over flat
observation lists.

The batched replacement of g2o's `BlockSolver_6_3` + LM algorithm driven by
`Optimizer::BundleAdjustment` / `LocalBundleAdjustment` /
`GlobalBundleAdjustemnt` (ref: corbslam_client/src/Optimizer.cc:54,487,43;
Thirdparty/g2o/g2o/core/block_solver.hpp). Same math, data-parallel layout:

  problem = poses Tcw [C,4,4] (+ fixed mask), points X [P,3],
            observations (cam_idx, point_idx, uvr, invSigma2, stereo, valid)

Per LM iteration (all inside one jit):
  1. gather + linearize all observations (optim/reproj.py)
  2. Huber IRLS weights
  3. per-point 3x3 Hessians by segment_sum, factored with unrolled Cholesky
  4. solve the reduced camera system S dc = b with MATRIX-FREE
     block-Jacobi-preconditioned CG. The Schur product is evaluated in
     RESIDUAL space:

         S v = sum_o Jc_o^T w_o (Jc_o v - Jp_o z_p),
         z_p = Hpp_d^-1 sum_o Jp_o^T w_o Jc_o v

     NOT as Hcc v - W Hpp^-1 W^T v: forming Hessian-scale products first
     (entries ~1e10 for KITTI focal lengths) and subtracting loses all f32
     significance — the subtraction must happen at Jacobian scale. This
     keeps the whole solver f32 with no f64 anywhere.
  5. back-substitute dp, LM accept/reject on the robust cost.

The [C,P] camera-point coupling blocks are never materialized, so the same
code path scales from a 20-KF local window to a pod-sharded global BA (the
observation list shards over devices and the CG reductions become psums —
see parallel/distributed_ba.py).

Gauge: fix at least one pose (pose_fixed mask), as the reference does
(vSE3->setFixed(nKFid==0), Optimizer.cc:101).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from . import reproj
from .smallmat import chol_solve_factored, chol_unrolled, inv_spd_unrolled

_PREC = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    Tcw: jnp.ndarray          # [C, 4, 4]
    pose_fixed: jnp.ndarray   # [C] bool (gauge + frontier + server-fixed)
    X: jnp.ndarray            # [P, 3]
    point_fixed: jnp.ndarray  # [P] bool (invalid slots or server-fixed)
    obs_cam: jnp.ndarray      # [O] i32
    obs_point: jnp.ndarray    # [O] i32
    obs_uvr: jnp.ndarray      # [O, 3]
    obs_inv_sigma2: jnp.ndarray  # [O]
    obs_stereo: jnp.ndarray   # [O] bool
    obs_valid: jnp.ndarray    # [O] bool


class BAResult(NamedTuple):
    Tcw: jnp.ndarray
    X: jnp.ndarray
    inlier: jnp.ndarray  # [O] final chi2 classification of observations
    cost: jnp.ndarray


def _linearize(cam, p: BAProblem, active):
    T_o = p.Tcw[p.obs_cam]
    X_o = p.X[p.obs_point]
    res = reproj.linearize(cam, T_o, X_o, p.obs_uvr, p.obs_inv_sigma2, p.obs_stereo)
    delta2 = reproj.chi2_threshold(p.obs_stereo)
    c2 = reproj.chi2(res.r, res.w)
    return res, c2, delta2


def _total_cost(c2, delta2, act_f, use_huber):
    rho = jnp.where(
        use_huber & (c2 > delta2),
        2.0 * jnp.sqrt(delta2 * jnp.maximum(c2, 1e-12)) - delta2,
        c2,
    )
    return jnp.sum(rho * act_f)


def lm_step(cam, p: BAProblem, active, lam, use_huber, cg_iters: int):
    """One LM iteration; returns proposed (Tcw, X)."""
    C, P = p.Tcw.shape[0], p.X.shape[0]
    res, c2, delta2 = _linearize(cam, p, active)
    rw = jnp.where(use_huber, reproj.huber_weights(c2, delta2), 1.0)
    act_f = (active & res.depth_ok).astype(jnp.float32)

    Jc = res.J_pose   # [O, 3, 6]
    Jp = res.J_point  # [O, 3, 3]
    w = res.w * (rw * act_f)[:, None]  # [O, 3] total row weights
    oc, op = p.obs_cam, p.obs_point
    free_c = (~p.pose_fixed).astype(jnp.float32)
    free_p = (~p.point_fixed).astype(jnp.float32)

    # Point Hessians + camera diagonal blocks (for damping + preconditioner).
    Jp_w = Jp * w[:, :, None]
    Hpp = jax.ops.segment_sum(
        jnp.einsum("ori,orj->oij", Jp_w, Jp, precision=_PREC), op, P
    )
    Jc_w = Jc * w[:, :, None]
    Hcc = jax.ops.segment_sum(
        jnp.einsum("ori,orj->oij", Jc_w, Jc, precision=_PREC), oc, C
    )
    eye3, eye6 = jnp.eye(3), jnp.eye(3 + 3)
    hpp_diag = jnp.einsum("pii->pi", Hpp)
    hcc_diag = jnp.einsum("cii->ci", Hcc)
    Hpp_d = Hpp + (lam * hpp_diag + 1e-6)[..., None] * eye3
    Lpp = chol_unrolled(Hpp_d, 3)

    def point_solve(y):  # [P, 3] -> Hpp_d^-1 y, fixed points give 0
        return chol_solve_factored(Lpp, y, 3) * free_p[:, None]

    def schur_mv(v):
        """S v in residual space; fixed cameras projected out."""
        v = v * free_c[:, None]
        a = jnp.einsum("orj,oj->or", Jc, v[oc], precision=_PREC)      # [O, 3]
        y = jax.ops.segment_sum(
            jnp.einsum("ori,or->oi", Jp_w, a, precision=_PREC), op, P
        )
        z = point_solve(y)
        m = a - jnp.einsum("orj,oj->or", Jp, z[op], precision=_PREC)  # residual-scale cancel
        Sv = jax.ops.segment_sum(
            jnp.einsum("ori,or->oi", Jc_w, m, precision=_PREC), oc, C
        )
        Sv = Sv + (lam * hcc_diag + 1e-8) * v  # LM damping on camera diag
        return Sv * free_c[:, None]

    # RHS. Normal equations for min |r + J d|^2_W are (J^T W J) d = -J^T W r,
    # so g_c = -Jc^T W r, g_p = -Jp^T W r, and the reduced RHS is
    # b = g_c - W_cp Hpp^-1 g_p = -sum_o Jc^T w (r - Jp z_g), z_g = Hpp^-1 (Jp^T w r).
    gp_pos = jax.ops.segment_sum(
        jnp.einsum("ori,or->oi", Jp_w, res.r, precision=_PREC), op, P
    )
    z_g = point_solve(gp_pos)
    m_b = res.r - jnp.einsum("orj,oj->or", Jp, z_g[op], precision=_PREC)
    b = -jax.ops.segment_sum(
        jnp.einsum("ori,or->oi", Jc_w, m_b, precision=_PREC), oc, C
    ) * free_c[:, None]

    # Block-Jacobi preconditioner from damped camera blocks.
    Hcc_d = Hcc + (lam * hcc_diag + 1e-8)[..., None] * jnp.eye(6)
    Minv = inv_spd_unrolled(Hcc_d, 6)

    def precond(r):
        return jnp.einsum("cij,cj->ci", Minv, r, precision=_PREC) * free_c[:, None]

    # PCG
    x = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0)

    def cg_body(state, _):
        x, r, pdir, rz = state
        Ap = schur_mv(pdir)
        pAp = jnp.sum(pdir * Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
        x = x + alpha * pdir
        r = r - alpha * Ap
        zz = precond(r)
        rz_new = jnp.sum(r * zz)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        return (x, r, zz + beta * pdir, rz_new), None

    (dc, _, _, _), _ = jax.lax.scan(cg_body, (x, r0, z0, rz0), None, length=cg_iters)

    # Back-substitute: dp = Hpp_d^-1 (g_p - Hpc dc) = -Hpp^-1 Jp^T w (r + Jc dc).
    a_dc = jnp.einsum("orj,oj->or", Jc, dc[oc], precision=_PREC)
    y2 = jax.ops.segment_sum(
        jnp.einsum("ori,or->oi", Jp_w, res.r + a_dc, precision=_PREC), op, P
    )
    dp = -point_solve(y2)

    T_new = se3.retract(p.Tcw, dc)
    T_new = jnp.where(p.pose_fixed[:, None, None], p.Tcw, T_new)
    X_new = p.X + dp
    return T_new, X_new, c2, delta2


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "huber_iters"))
def optimize(
    cam: cam_mod.Intrinsics,
    problem: BAProblem,
    n_iters: int = 10,
    cg_iters: int = 40,
    huber_iters: int = 5,
) -> BAResult:
    """LM loop with accept/reject; `huber_iters` initial robust iterations
    mirror the reference's 5-robust + 10-plain local BA schedule
    (Optimizer.cc:711-758: re-classify outliers after round one)."""

    def body(state, it):
        p, lam, active = state
        use_huber = it < huber_iters
        T_new, X_new, c2_old, delta2 = lm_step(cam, p, active, lam, use_huber, cg_iters)
        p_new = p._replace(Tcw=T_new, X=X_new)
        _, c2_new, _ = _linearize(cam, p_new, active)
        act_f = active.astype(jnp.float32)
        cost_new = _total_cost(c2_new, delta2, act_f, use_huber)
        cost_old = _total_cost(c2_old, delta2, act_f, use_huber)
        accept = cost_new < cost_old
        p = jax.tree.map(
            lambda a, b: jnp.where(jnp.reshape(accept, (1,) * a.ndim), a, b),
            p_new,
            p,
        )
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), jnp.minimum(lam * 5.0, 1e3))
        # After the robust phase, drop outlier observations (chi2 gate),
        # mirroring the re-optimization without kernel (Optimizer.cc:711-731).
        _, c2_cur, _ = _linearize(cam, p, active)
        reclass = active & (c2_cur <= delta2)
        active = jnp.where(it == huber_iters - 1, reclass, active)
        return (p, lam, active), cost_old

    active0 = problem.obs_valid
    (p, _, active), costs = jax.lax.scan(
        body, (problem, jnp.float32(1e-4), active0), jnp.arange(n_iters)
    )

    _, c2, delta2 = _linearize(cam, p, active)
    inlier = problem.obs_valid & (c2 <= delta2)
    cost = _total_cost(c2, delta2, active.astype(jnp.float32), False)
    return BAResult(p.Tcw, p.X, inlier, cost)
