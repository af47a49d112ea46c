"""Batched Horn similarity alignment + RANSAC.

Replaces `Sim3Solver` (ref: corbslam_client/src/Sim3Solver.cc: Horn 1987
closed-form from 3 correspondences, RANSAC loop `iterate` h45, fixed-scale
mode for stereo). Re-design: ALL RANSAC hypotheses are solved at once —
sample [H, 3] correspondence triples, vmap the closed form, count inliers
with one batched reprojection, pick the argmax. The reference's sequential
`mRansacMaxIts` loop becomes a single fixed-shape program.

The quaternion eigen-problem inside Horn (largest eigenvector of the 4x4 N
matrix) is solved with shifted power iteration — pure arithmetic instead of
a batched eigensolver.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..geometry import sim3 as _sim3_mod

_PREC = jax.lax.Precision.HIGHEST


def horn_sim3(
    p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool = False,
    w: jnp.ndarray | None = None,
):
    """Closed-form similarity p1 ~ s R p2 + t from matched sets [..., K, 3].

    Horn's quaternion method (the same construction as Sim3Solver::ComputeSim3,
    Sim3Solver.cc h56). Batched over leading dims. `w` [..., K] optionally
    weights/masks correspondences (inlier refit after RANSAC — the role of
    the reference's final Sim3 refinement over the consensus set).
    """
    if w is None:
        w = jnp.ones(p1.shape[:-1], p1.dtype)
    wn = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)
    c1 = jnp.sum(p1 * wn[..., None], axis=-2, keepdims=True)
    c2 = jnp.sum(p2 * wn[..., None], axis=-2, keepdims=True)
    q1 = (p1 - c1) * jnp.sqrt(wn)[..., None]
    q2 = (p2 - c2) * jnp.sqrt(wn)[..., None]
    M = jnp.einsum("...ki,...kj->...ij", q2, q1, precision=_PREC)  # [3,3]
    # 4x4 symmetric N matrix
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )
    # Largest eigenvector via shifted power iteration. The shift must make
    # N + shift*I PSD but stay TIGHT: convergence goes like
    # ((l2+s)/(l1+s))^k, so an oversized shift kills the eigengap. Use the
    # Gershgorin lower bound on lambda_min.
    diag = jnp.einsum("...ii->...i", N)
    radius = jnp.sum(jnp.abs(N), axis=-1) - jnp.abs(diag)
    gersh_min = jnp.min(diag - radius, axis=-1)
    shift = jnp.maximum(-gersh_min, 0.0)[..., None, None]
    Ns = N + shift * jnp.broadcast_to(jnp.eye(4), N.shape)
    v = jnp.ones(N.shape[:-1], N.dtype)

    def body(v, _):
        v = jnp.einsum("...ij,...j->...i", Ns, v, precision=_PREC)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        return v, None

    v, _ = jax.lax.scan(body, v, None, length=100)
    # q = (w, x, y, z) rotating p2 into p1
    R = se3.R_from_quat(v)

    q2r = jnp.einsum("...ij,...kj->...ki", R, q2, precision=_PREC)
    if fix_scale:
        s = jnp.ones(p1.shape[:-2], p1.dtype)
    else:
        num = jnp.sum(q1 * q2r, axis=(-1, -2))
        den = jnp.sum(q2r * q2r, axis=(-1, -2))
        s = num / jnp.maximum(den, 1e-12)
    t = (c1[..., 0, :] - s[..., None] * jnp.einsum(
        "...ij,...j->...i", R, c2[..., 0, :], precision=_PREC
    ))
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    s: jnp.ndarray
    inliers: jnp.ndarray   # [N] bool
    n_inliers: jnp.ndarray
    ok: jnp.ndarray        # found a model above threshold


def _sim3_chi2(cam1, cam2, p1_cam, p2_cam, R, t, s):
    """Per-correspondence squared reprojection error of a Sim3 in BOTH
    cameras (Sim3Solver::CheckInliers geometry, Sim3Solver.cc:~200).
    Returns (e1, e2, cheirality_ok)."""
    p2_in1 = s * jnp.matmul(p2_cam, R.T, precision=_PREC) + t
    s_inv = 1.0 / jnp.maximum(s, 1e-12)
    p1_in2 = s_inv * jnp.matmul(p1_cam - t, R, precision=_PREC)
    uv1_obs = cam_mod.project(cam1, p1_cam)
    uv2_obs = cam_mod.project(cam2, p2_cam)
    e1 = jnp.sum((cam_mod.project(cam1, p2_in1) - uv1_obs) ** 2, axis=-1)
    e2 = jnp.sum((cam_mod.project(cam2, p1_in2) - uv2_obs) ** 2, axis=-1)
    return e1, e2, (p2_in1[..., 2] > 0) & (p1_in2[..., 2] > 0)


def refine_sim3_iterative(
    cam1: cam_mod.Intrinsics,
    cam2: cam_mod.Intrinsics,
    p1_cam: jnp.ndarray,      # [N, 3]
    p2_cam: jnp.ndarray,      # [N, 3]
    valid: jnp.ndarray,       # [N]
    sigma2_1: jnp.ndarray,
    sigma2_2: jnp.ndarray,
    R0, t0, s0,
    fix_scale: bool = False,
    n_rounds: int = 3,
):
    """Robust iterative Sim3 refinement with inlier RE-CLASSIFICATION —
    the role of the reference's `Optimizer::OptimizeSim3` (Optimizer.cc:1120:
    g2o iterations with Huber kernels, dropping chi2 outliers and
    re-optimizing; gated >= 20 inliers at GlobalOptimize.cpp:147-151).

    Each round is one damped Gauss-Newton step on the Sim3 manifold
    minimizing the Huber-weighted REPROJECTION error in both cameras —
    the same objective as the reference's g2o edges (not Horn's 3D
    distance, whose least-squares optimum differs under depth-heavy
    noise). Every correspondence is re-weighted each round, so matches
    the RANSAC consensus missed re-enter as the model improves.
    Returns (R, t, s, inliers [N], n_inliers).
    """
    from ..optim.smallmat import chol_solve_factored, chol_unrolled

    uv1_obs = cam_mod.project(cam1, p1_cam)
    uv2_obs = cam_mod.project(cam2, p2_cam)
    v_f = valid.astype(jnp.float32)
    inv_s2_1 = 1.0 / jnp.maximum(sigma2_1, 1e-9)
    inv_s2_2 = 1.0 / jnp.maximum(sigma2_2, 1e-9)

    def proj_diff(cam, q):
        """[N, 2, 3] differential of pinhole projection at q."""
        z = jnp.maximum(q[..., 2], 1e-3)
        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        zero = jnp.zeros_like(z)
        return jnp.stack([
            jnp.stack([cam.fx * inv_z, zero, -cam.fx * q[..., 0] * inv_z2], -1),
            jnp.stack([zero, cam.fy * inv_z, -cam.fy * q[..., 1] * inv_z2], -1),
        ], -2)

    def hat_cols(p):
        """[N, 3, 7] action Jacobian d(exp(xi) p)/dxi for xi=(rho,phi,lam):
        [I | -hat(p) | p]."""
        N = p.shape[0]
        I = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), (N, 3, 3))
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        zero = jnp.zeros_like(x)
        neg_hat = jnp.stack([
            jnp.stack([zero, z, -y], -1),
            jnp.stack([-z, zero, x], -1),
            jnp.stack([y, -x, zero], -1),
        ], -2)
        return jnp.concatenate([I, neg_hat, p[:, :, None]], axis=-1)

    def gn_round(carry, _):
        R, t, s = carry
        q = s * jnp.matmul(p2_cam, R.T, precision=_PREC) + t                # S p2, cam-1 frame
        s_inv = 1.0 / jnp.maximum(s, 1e-12)
        p = s_inv * jnp.matmul(p1_cam - t, R, precision=_PREC)            # S^-1 p1, cam-2 frame
        r1 = cam_mod.project(cam1, q) - uv1_obs    # [N, 2]
        r2 = cam_mod.project(cam2, p) - uv2_obs
        c1 = jnp.sum(r1 * r1, -1) * inv_s2_1
        c2 = jnp.sum(r2 * r2, -1) * inv_s2_2
        # IRLS Huber weights at delta2 = 9.21 (the CheckInliers gate), plus
        # cheirality masks.
        hub = lambda c: jnp.where(c > 9.21, jnp.sqrt(9.21 / jnp.maximum(c, 1e-9)), 1.0)
        w1 = v_f * (q[..., 2] > 1e-3) * hub(c1) * inv_s2_1
        w2 = v_f * (p[..., 2] > 1e-3) * hub(c2) * inv_s2_2
        # J1 = A(q) [I | -hat(q) | q]  (left-multiplicative update on S).
        J1 = jnp.einsum("nij,njk->nik", proj_diff(cam1, q), hat_cols(q),
                        precision=_PREC)
        # r2's point moves by -S^-1 [I | -hat(p1) | p1] xi.
        Jp = -s_inv * jnp.einsum(
            "ji,njk->nik", R, hat_cols(p1_cam), precision=_PREC)
        J2 = jnp.einsum("nij,njk->nik", proj_diff(cam2, p), Jp,
                        precision=_PREC)
        H = (jnp.einsum("nik,n,nil->kl", J1, w1, J1, precision=_PREC)
             + jnp.einsum("nik,n,nil->kl", J2, w2, J2, precision=_PREC))
        g = (jnp.einsum("nik,n,ni->k", J1, w1, r1, precision=_PREC)
             + jnp.einsum("nik,n,ni->k", J2, w2, r2, precision=_PREC))
        if fix_scale:
            mask = jnp.arange(7) < 6
            H = jnp.where(mask[:, None] & mask[None, :], H, 0.0)
            g = jnp.where(mask, g, 0.0)
        H = H + (1e-4 * jnp.diagonal(H) + 1e-8) * jnp.eye(7)
        dx = -chol_solve_factored(chol_unrolled(H, 7), g, 7)
        Rn, tn, sn = _sim3_mod.retract((R, t, s), dx)
        ok = jnp.isfinite(dx).all() & (jnp.sum(v_f) >= 3)
        return (
            jnp.where(ok, Rn, R),
            jnp.where(ok, tn, t),
            jnp.where(ok, sn, s),
        ), None

    (R, t, s), _ = jax.lax.scan(gn_round, (R0, t0, s0), None,
                                length=n_rounds)
    e1, e2, pos = _sim3_chi2(cam1, cam2, p1_cam, p2_cam, R, t, s)
    inl = ((e1 < 9.21 * sigma2_1) & (e2 < 9.21 * sigma2_2) & pos & valid)
    # Keep the refined model only if it classifies at least as many
    # inliers as the input model did (monotone acceptance).
    e1o, e2o, poso = _sim3_chi2(cam1, cam2, p1_cam, p2_cam, R0, t0, s0)
    inl0 = ((e1o < 9.21 * sigma2_1) & (e2o < 9.21 * sigma2_2) & poso & valid)
    better = jnp.sum(inl) >= jnp.sum(inl0)
    R = jnp.where(better, R, R0)
    t = jnp.where(better, t, t0)
    s = jnp.where(better, s, s0)
    inl = jnp.where(better, inl, inl0)
    return R, t, s, inl, jnp.sum(inl)


@partial(jax.jit, static_argnames=("cam1", "cam2", "n_hyp", "fix_scale"))
def solve_sim3_ransac(
    cam1: cam_mod.Intrinsics,
    cam2: cam_mod.Intrinsics,
    p1_cam: jnp.ndarray,      # [N, 3] points in camera-1 frame
    p2_cam: jnp.ndarray,      # [N, 3] matched points in camera-2 frame
    valid: jnp.ndarray,       # [N]
    sigma2_1: jnp.ndarray,    # [N] per-match pixel noise (octave sigma^2), img 1
    sigma2_2: jnp.ndarray,    # [N]
    key: jnp.ndarray,
    n_hyp: int = 128,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3RansacResult:
    """Full RANSAC in one program. Inlier test mirrors Sim3Solver::CheckInliers
    (Sim3Solver.cc:~200): project each point into BOTH cameras with the
    candidate S12 / S21 and gate reprojection error at 9.21 * sigma2."""
    N = p1_cam.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 3), p=probs)
    tri1 = p1_cam[idx]  # [H, 3, 3]
    tri2 = p2_cam[idx]
    R, t, s = horn_sim3(tri1, tri2, fix_scale)  # [H, ...]

    # Inlier check per hypothesis: err1 = |proj1(s R p2 + t) - proj1(p1)|
    p2_in1 = s[:, None, None] * jnp.einsum(
        "hij,nj->hni", R, p2_cam, precision=_PREC
    ) + t[:, None, :]
    Rinv = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / jnp.maximum(s, 1e-12)
    diff = p1_cam[None, :, :] - t[:, None, :]  # [H, N, 3]
    p1_in2 = s_inv[:, None, None] * jnp.einsum(
        "hij,hnj->hni", Rinv, diff, precision=_PREC
    )
    uv1_obs = cam_mod.project(cam1, p1_cam)
    uv2_obs = cam_mod.project(cam2, p2_cam)
    e1 = jnp.sum((cam_mod.project(cam1, p2_in1) - uv1_obs[None]) ** 2, axis=-1)
    e2 = jnp.sum((cam_mod.project(cam2, p1_in2) - uv2_obs[None]) ** 2, axis=-1)
    inl = (e1 < 9.21 * sigma2_1[None]) & (e2 < 9.21 * sigma2_2[None]) & valid[None]
    inl &= (p2_in1[..., 2] > 0) & (p1_in2[..., 2] > 0)
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    n_in = counts[best]
    return Sim3RansacResult(
        R=R[best], t=t[best], s=s[best],
        inliers=inl[best], n_inliers=n_in, ok=n_in >= min_inliers,
    )
