"""Motion-only pose optimization (one camera, fixed points).

Batched equivalent of `Optimizer::PoseOptimization` (ref:
corbslam_client/src/Optimizer.cc:272): Levenberg-Marquardt on a single SE3
pose against its matched map points, 4 outer rounds of 10 iterations with
chi-square inlier re-classification between rounds, Huber kernel active for
the first two rounds only (the reference drops the kernel after round 2,
Optimizer.cc:458).

Fully jitted: fixed iteration counts, masks instead of edge removal. The
6x6 normal system is solved with `jnp.linalg.solve` (fine for tiny
fixed shapes). vmap over the leading axis gives batched multi-frame /
multi-hypothesis pose optimization for free (used by relocalization RANSAC).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from . import reproj

_PREC = jax.lax.Precision.HIGHEST


class PoseOptResult(NamedTuple):
    Tcw: jnp.ndarray      # [4, 4] optimized pose
    inliers: jnp.ndarray  # [K] bool final inlier classification
    n_inliers: jnp.ndarray  # scalar i32
    cost: jnp.ndarray     # scalar final robust cost


def _normal_system(res: reproj.Residuals, robust_w: jnp.ndarray, active: jnp.ndarray):
    """H [6,6], g [6] from masked observations. g solves H d = g with
    d minimizing |r - J d|^2 (note r = obs-pred, J = dr/dxi)."""
    w = res.w * (robust_w * active)[:, None]  # [K, 3]
    Jw = res.J_pose * w[:, :, None]  # [K, 3, 6]
    H = jnp.einsum("kri,krj->ij", Jw, res.J_pose, precision=_PREC)
    # minimize |r + J d|^2_w  =>  (JᵀWJ) d = -JᵀW r
    g = -jnp.einsum("kri,kr->i", Jw, res.r, precision=_PREC)
    return H, g


def _robust_cost(c2: jnp.ndarray, delta2: jnp.ndarray, use_huber, active) -> jnp.ndarray:
    # Huber rho(s): s if s<=d2 else 2*delta*sqrt(s)-d2
    rho = jnp.where(
        use_huber & (c2 > delta2),
        2.0 * jnp.sqrt(delta2 * jnp.maximum(c2, 1e-12)) - delta2,
        c2,
    )
    return jnp.sum(rho * active)


@partial(jax.jit, static_argnames=("n_rounds", "n_iters"))
def optimize_pose(
    cam: cam_mod.Intrinsics,
    T_init: jnp.ndarray,
    X: jnp.ndarray,          # [K, 3] world points
    obs: jnp.ndarray,        # [K, 3] (u, v, uR)
    inv_sigma2: jnp.ndarray, # [K]
    is_stereo: jnp.ndarray,  # [K]
    valid: jnp.ndarray,      # [K] has a map-point match
    n_rounds: int = 4,
    n_iters: int = 10,
) -> PoseOptResult:
    delta2 = reproj.chi2_threshold(is_stereo)  # Huber delta^2 == chi2 gate

    def lm_round(carry, round_idx):
        T, inliers = carry
        use_huber = round_idx < 2

        def lm_iter(state, _):
            T, lam, cost = state
            TK = jnp.broadcast_to(T, (X.shape[0], 4, 4))
            res = reproj.linearize(cam, TK, X, obs, inv_sigma2, is_stereo)
            c2 = reproj.chi2(res.r, res.w)
            rw = jnp.where(use_huber, reproj.huber_weights(c2, delta2), 1.0)
            active = (inliers & valid & res.depth_ok).astype(jnp.float32)
            H, g = _normal_system(res, rw, active)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-10 * jnp.eye(6)
            d = jnp.linalg.solve(Hd, g)
            T_new = se3.retract(T, d)
            # Evaluate new cost
            TKn = jnp.broadcast_to(T_new, (X.shape[0], 4, 4))
            res_n = reproj.linearize(cam, TKn, X, obs, inv_sigma2, is_stereo)
            c2n = reproj.chi2(res_n.r, res_n.w)
            cost_new = _robust_cost(c2n, delta2, use_huber, active)
            accept = cost_new < cost
            T = jnp.where(accept, T_new, T)
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), jnp.minimum(lam * 4.0, 1e4))
            cost = jnp.where(accept, cost_new, cost)
            return (T, lam, cost), None

        # Initial cost with current inliers
        TK = jnp.broadcast_to(T, (X.shape[0], 4, 4))
        res0 = reproj.linearize(cam, TK, X, obs, inv_sigma2, is_stereo)
        c20 = reproj.chi2(res0.r, res0.w)
        active0 = (inliers & valid & res0.depth_ok).astype(jnp.float32)
        cost0 = _robust_cost(c20, delta2, use_huber, active0)
        (T, _, cost), _ = jax.lax.scan(lm_iter, (T, 1e-3, cost0), None, length=n_iters)

        # Re-classify inliers at the new pose (Optimizer.cc:412-452)
        TK = jnp.broadcast_to(T, (X.shape[0], 4, 4))
        res = reproj.linearize(cam, TK, X, obs, inv_sigma2, is_stereo)
        c2 = reproj.chi2(res.r, res.w)
        inliers = valid & res.depth_ok & (c2 <= delta2)
        return (T, inliers), cost

    (T, inliers), costs = jax.lax.scan(
        lm_round, (T_init, valid), jnp.arange(n_rounds)
    )
    # Renormalize the rotation before the pose re-enters the per-frame
    # velocity/predict chain — see se3.orthonormalize_fast for why skipping
    # this compounds f32 error exponentially across frames.
    T = se3.orthonormalize_fast(T)
    return PoseOptResult(T, inliers, jnp.sum(inliers.astype(jnp.int32)), costs[-1])


# Batched over hypotheses/frames: used by relocalization-style RANSAC.
optimize_pose_batch = jax.vmap(
    optimize_pose, in_axes=(None, 0, 0, 0, 0, 0, 0), out_axes=0
)
