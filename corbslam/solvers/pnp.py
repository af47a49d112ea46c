"""Batched absolute-pose (PnP) RANSAC.

Replaces `PnPsolver` (ref: corbslam_client/src/PnPsolver.cc: EPnP control
points + Gauss-Newton betas + sequential RANSAC `iterate` h73), used by
relocalization (Tracking.cc:1413-1439) and server map alignment
(MapFusion.cpp:699-745). Re-design:

  * each RANSAC hypothesis solves pose from 6 correspondences by DLT
    (12-dim nullspace of A^T A, found with SHIFTED POWER ITERATION on
    lambda_max*I - A^T A — no eigensolver),
  * the rotation block is projected to SO(3) with a Newton polar
    decomposition (X <- (X + X^-T)/2, Cramer 3x3 inverses),
  * all H hypotheses run as one vmapped program; inliers counted with one
    batched projection; the best model is refined by the motion-only LM
    (optim/pose_opt.py), mirroring the reference's EPnP -> PoseOptimization
    hand-off.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3

_PREC = jax.lax.Precision.HIGHEST


def _dlt_pose(X: jnp.ndarray, uv_norm: jnp.ndarray):
    """Pose from K normalized correspondences (one hypothesis).

    X [K, 3] world, uv_norm [K, 2] normalized image coords. Returns
    (R [3,3], t [3]) with projective scale fixed by cheirality + unit-det.
    """
    K = X.shape[0]
    # Hartley normalization of the world points: without it the homogeneous
    # column (1) is orders of magnitude off the coordinate columns and the
    # f32 nullspace is garbage.
    c = jnp.mean(X, axis=0)
    Xc = X - c
    sigma = jnp.sqrt(jnp.mean(jnp.sum(Xc * Xc, axis=1)) / 3.0)
    sigma = jnp.maximum(sigma, 1e-6)
    Xn = Xc / sigma

    zeros = jnp.zeros((K, 4), X.dtype)
    Xh = jnp.concatenate([Xn, jnp.ones((K, 1), X.dtype)], axis=1)  # [K, 4]
    u = uv_norm[:, 0:1]
    v = uv_norm[:, 1:2]
    rows_u = jnp.concatenate([Xh, zeros, -u * Xh], axis=1)  # [K, 12]
    rows_v = jnp.concatenate([zeros, Xh, -v * Xh], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # [2K, 12]
    AtA = jnp.matmul(A.T, A, precision=_PREC)
    # Smallest eigenvector via INVERSE iteration (power iteration on a
    # shifted matrix cannot separate the two smallest eigenvalues —
    # convergence ratio 1 - gap/shift). Regularized Cholesky, unrolled 12x12.
    from ..optim.smallmat import chol_solve_factored, chol_unrolled

    eps = 1e-7 * jnp.trace(AtA) + 1e-12
    L = chol_unrolled(AtA + eps * jnp.eye(12, dtype=A.dtype), 12)
    p = jnp.ones(12, A.dtype) / jnp.sqrt(12.0)

    def body(p, _):
        p = chol_solve_factored(L, p, 12)
        return p / jnp.maximum(jnp.linalg.norm(p), 1e-20), None

    p, _ = jax.lax.scan(body, p, None, length=8)
    Pn = p.reshape(3, 4)
    # Denormalize: P = Pn @ T with T = [[I/sigma, -c/sigma], [0, 1]].
    T_norm = jnp.concatenate(
        [
            jnp.concatenate([jnp.eye(3, dtype=X.dtype) / sigma, (-c / sigma)[:, None]], axis=1),
            jnp.asarray([[0.0, 0.0, 0.0, 1.0]], X.dtype),
        ],
        axis=0,
    )
    P = jnp.matmul(Pn, T_norm, precision=_PREC)
    M = P[:, :3]
    # Fix sign/scale: det(M) > 0 and |M| scaled so R orthonormal on average.
    detM = jnp.linalg.det(M)
    sign = jnp.where(detM < 0, -1.0, 1.0)
    P = P * sign
    M = P[:, :3]
    scale = jnp.cbrt(jnp.maximum(jnp.abs(detM), 1e-20))
    M = M / scale
    t = P[:, 3] / scale
    # Polar decomposition by Newton iteration: R = lim X_{k+1}=(X + X^-T)/2.
    from ..geometry.camera import solve3x3  # Cramer machinery

    def inv3(Mx):
        cols = jnp.stack(
            [solve3x3(Mx[None], jnp.eye(3, dtype=Mx.dtype)[i][None])[0] for i in range(3)],
            axis=-1,
        )
        return cols

    def polar_step(Xk, _):
        Xinv = inv3(Xk)  # columns solve Xk x = e_i => Xk^-1
        return 0.5 * (Xk + Xinv.T), None

    R, _ = jax.lax.scan(polar_step, M, None, length=8)
    return R, t


class PnPResult(NamedTuple):
    Tcw: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "n_hyp", "min_inliers"))
def solve_pnp_ransac(
    cam: cam_mod.Intrinsics,
    X: jnp.ndarray,        # [N, 3] world points
    uv: jnp.ndarray,       # [N, 2] observed pixels
    valid: jnp.ndarray,    # [N]
    sigma2: jnp.ndarray,   # [N] per-obs noise (octave sigma^2)
    key: jnp.ndarray,
    n_hyp: int = 256,
    min_inliers: int = 15,
    chi2_th: float = 5.991,
) -> PnPResult:
    """Full PnP RANSAC in one fixed-shape program (the reference iterates
    5 RANSAC rounds per call per candidate, Tracking.cc:1414)."""
    N = X.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 6), p=probs)
    x_norm = (uv[:, 0] - cam.cx) / cam.fx
    y_norm = (uv[:, 1] - cam.cy) / cam.fy
    uvn = jnp.stack([x_norm, y_norm], axis=-1)

    R, t = jax.vmap(_dlt_pose)(X[idx], uvn[idx])  # [H, 3, 3], [H, 3]

    p_cam = jnp.einsum("hij,nj->hni", R, X, precision=_PREC) + t[:, None, :]
    uv_pred = cam_mod.project(cam, p_cam)  # [H, N, 2]
    err2 = jnp.sum((uv_pred - uv[None]) ** 2, axis=-1)
    inl = (err2 < chi2_th * sigma2[None]) & (p_cam[..., 2] > 0) & valid[None]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    Tcw = se3.from_Rt(R[best], t[best])
    n_in = counts[best]
    return PnPResult(Tcw, inl[best], n_in, n_in >= min_inliers)
