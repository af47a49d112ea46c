"""Monocular two-view bootstrap: parallel homography / fundamental RANSAC,
model selection, and pose + structure reconstruction.

Replaces `Initializer` (ref: corbslam_client/src/Initializer.cc: threaded
FindHomography/FindFundamental h48-49 with normalized 8-point / DLT,
symmetric-transfer scoring CheckHomography/CheckFundamental, RH = SH/(SH+SF)
model selection :~120, ReconstructF :~580 with the 4-way essential
decomposition, ReconstructH :~650 with the Faugeras 8-solution homography
decomposition, and CheckRT triangulation gating).

Re-design: every RANSAC hypothesis for BOTH models is solved at once —
[H_hyp, 8] samples, null vectors via shifted power iteration on the 9x9
normal matrices, 3x3 spectral ops in closed form (geometry/linalg3.py) —
and all 4+8 reconstruction candidates are verified by one vmapped
triangulate-and-count program. No per-hypothesis SVDs, no host loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import linalg3
from ..mapping.triangulation import triangulate_midpoint

_PREC = jax.lax.Precision.HIGHEST


def _mm(*Ms):
    """Chained matmul at HIGHEST precision — accelerator f32 matmuls default to
    reduced-precision (TF32) passes, which is fatal for rotation reconstruction (a ~1%% rotation
    error fails every reprojection gate)."""
    out = Ms[0]
    for M in Ms[1:]:
        out = jnp.matmul(out, M, precision=_PREC)
    return out

CHI2_F = 3.841   # 1-DoF epipolar distance gate (Initializer.cc CheckFundamental)
CHI2_H = 5.991   # 2-DoF transfer error gate (CheckHomography)
SCORE_TH = 5.991  # score accumulator offset (both use thScore = 5.991)


def _normalize(xy: jnp.ndarray, valid: jnp.ndarray):
    """Isotropic normalization (Initializer::Normalize): zero mean, unit
    mean absolute deviation, computed over valid points."""
    w = valid.astype(xy.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(xy * w[:, None], 0) / n
    d = jnp.abs(xy - mean) * w[:, None]
    md = jnp.sum(d, 0) / n
    s = 1.0 / jnp.maximum(md, 1e-9)
    xn = (xy - mean) * s
    T = jnp.asarray([[s[0], 0.0, -mean[0] * s[0]],
                     [0.0, s[1], -mean[1] * s[1]],
                     [0.0, 0.0, 1.0]])
    return xn, T


def _eight_point_F(x1: jnp.ndarray, x2: jnp.ndarray,
                   w: jnp.ndarray | None = None) -> jnp.ndarray:
    """F from >=8 normalized correspondences [..., K, 2], x2^T F x1 = 0,
    rank-2 enforced. Batched; `w` optionally weights/masks rows (the
    refit-over-all-inliers pass the reference runs after RANSAC,
    Initializer::FindFundamental)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )  # [..., K, 9]
    if w is not None:
        A = A * w[..., None]
    M = jnp.einsum("...ki,...kj->...ij", A, A, precision=_PREC)
    f = linalg3.smallest_eigvec_sym(M)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # Rank-2 projection: subtract the smallest singular component.
    U, s, V = linalg3.svd3x3(F)
    u3 = U[..., :, 2]
    v3 = V[..., :, 2]
    sig3 = jnp.einsum("...i,...ij,...j->...", u3, F, v3, precision=_PREC)
    return F - sig3[..., None, None] * u3[..., :, None] * v3[..., None, :]


def _dlt_H(x1: jnp.ndarray, x2: jnp.ndarray,
           w: jnp.ndarray | None = None) -> jnp.ndarray:
    """H from >=4 normalized correspondences, x2 ~ H x1. Batched."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = jnp.ones_like(u1)
    zero = jnp.zeros_like(u1)
    r1 = jnp.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], -1)
    r2 = jnp.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], -1)
    A = jnp.concatenate([r1, r2], axis=-2)  # [..., 2K, 9]
    if w is not None:
        A = A * jnp.concatenate([w, w], axis=-1)[..., None]
    M = jnp.einsum("...ki,...kj->...ij", A, A, precision=_PREC)
    h = linalg3.smallest_eigvec_sym(M)
    return h.reshape(*h.shape[:-1], 3, 3)


def _score_F(F, xy1, xy2, valid, inv_sigma2):
    """Symmetric epipolar-distance score (CheckFundamental). Returns
    (score, inliers [N])."""
    one = jnp.ones_like(xy1[:, :1])
    p1 = jnp.concatenate([xy1, one], -1)
    p2 = jnp.concatenate([xy2, one], -1)
    l2 = jnp.einsum("ij,nj->ni", F, p1, precision=_PREC)   # line in img2
    l1 = jnp.einsum("ji,nj->ni", F, p2, precision=_PREC)   # line in img1
    d2 = (jnp.sum(l2 * p2, -1) ** 2) / jnp.maximum(
        l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12
    )
    d1 = (jnp.sum(l1 * p1, -1) ** 2) / jnp.maximum(
        l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12
    )
    c1 = d1 * inv_sigma2
    c2 = d2 * inv_sigma2
    ok = (c1 < CHI2_F) & (c2 < CHI2_F) & valid
    sc = jnp.where(c1 < CHI2_F, SCORE_TH - c1, 0.0) + jnp.where(
        c2 < CHI2_F, SCORE_TH - c2, 0.0
    )
    return jnp.sum(jnp.where(valid, sc, 0.0)), ok


def _score_H(H, Hinv, xy1, xy2, valid, inv_sigma2):
    one = jnp.ones_like(xy1[:, :1])
    p1 = jnp.concatenate([xy1, one], -1)
    p2 = jnp.concatenate([xy2, one], -1)
    q2 = jnp.einsum("ij,nj->ni", H, p1, precision=_PREC)
    q2 = q2[:, :2] / jnp.where(jnp.abs(q2[:, 2:]) < 1e-12, 1e-12, q2[:, 2:])
    q1 = jnp.einsum("ij,nj->ni", Hinv, p2, precision=_PREC)
    q1 = q1[:, :2] / jnp.where(jnp.abs(q1[:, 2:]) < 1e-12, 1e-12, q1[:, 2:])
    c2 = jnp.sum((q2 - xy2) ** 2, -1) * inv_sigma2
    c1 = jnp.sum((q1 - xy1) ** 2, -1) * inv_sigma2
    ok = (c1 < CHI2_H) & (c2 < CHI2_H) & valid
    sc = jnp.where(c1 < CHI2_H, SCORE_TH - c1, 0.0) + jnp.where(
        c2 < CHI2_H, SCORE_TH - c2, 0.0
    )
    return jnp.sum(jnp.where(valid, sc, 0.0)), ok


def _check_rt(cam, R, t, xy1, xy2, valid, inv_sigma2):
    """Triangulate all matches for candidate (R, t) and count the good ones
    (CheckRT, Initializer.cc:~750): cheirality in both views, parallax,
    reprojection under 4 sigma^2. Returns (n_good, X, good, median_cos)."""
    N = xy1.shape[0]
    o1 = jnp.zeros(3)
    o2 = -jnp.matmul(R.T, t, precision=_PREC)
    d1 = cam_mod.backproject(cam, xy1, jnp.ones(N))
    d2c = cam_mod.backproject(cam, xy2, jnp.ones(N))
    d2 = jnp.einsum("ji,nj->ni", R, d2c, precision=_PREC)
    X, s1, s2 = triangulate_midpoint(
        jnp.broadcast_to(o1, (N, 3)), d1, jnp.broadcast_to(o2, (N, 3)), d2
    )
    p1c = X
    p2c = jnp.einsum("ij,nj->ni", R, X, precision=_PREC) + t
    cheir = (p1c[:, 2] > 0) & (p2c[:, 2] > 0)
    r1 = X - o1
    r2 = X - o2
    cospar = jnp.sum(r1 * r2, -1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
    )
    par_ok = cospar < 0.99998
    e1 = jnp.sum((cam_mod.project(cam, p1c) - xy1) ** 2, -1) * inv_sigma2
    e2 = jnp.sum((cam_mod.project(cam, p2c) - xy2) ** 2, -1) * inv_sigma2
    good = valid & cheir & par_ok & (e1 < 4.0) & (e2 < 4.0)
    n_good = jnp.sum(good)
    return n_good, X, good, cospar


class InitResult(NamedTuple):
    ok: jnp.ndarray
    used_H: jnp.ndarray
    R: jnp.ndarray      # cam2 <- cam1 rotation (T21)
    t: jnp.ndarray      # unit-norm translation (scale-free, mono)
    X: jnp.ndarray      # [N, 3] points in cam1 frame
    good: jnp.ndarray   # [N] triangulated inliers
    n_good: jnp.ndarray
    score_h: jnp.ndarray
    score_f: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "n_hyp", "min_triangulated"))
def initialize_two_view(
    cam: cam_mod.Intrinsics,
    xy1: jnp.ndarray,     # [N, 2] matched pixels, frame 1
    xy2: jnp.ndarray,     # [N, 2] matched pixels, frame 2
    valid: jnp.ndarray,   # [N]
    key: jnp.ndarray,
    n_hyp: int = 256,
    sigma: float = 1.0,
    min_triangulated: int = 50,
) -> InitResult:
    """Full two-view initialization in one program."""
    N = xy1.shape[0]
    inv_sigma2 = 1.0 / (sigma * sigma)
    x1n, T1 = _normalize(xy1, valid)
    x2n, T2 = _normalize(xy2, valid)

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 8), p=probs)

    # --- fundamental hypotheses --------------------------------------
    Fn = _eight_point_F(x1n[idx], x2n[idx])             # [H, 3, 3]
    F = jnp.einsum("ji,hjk,kl->hil", T2, Fn, T1, precision=_PREC)
    sF, okF = jax.vmap(lambda f: _score_F(f, xy1, xy2, valid, inv_sigma2))(F)
    bF = jnp.argmax(sF)
    inl_F = okF[bF]
    # Refit on ALL inliers of the best hypothesis, then rescore
    # (FindFundamental's final full-inlier solve).
    Fn_ref = _eight_point_F(x1n, x2n, w=inl_F.astype(jnp.float32))
    F_best = jnp.einsum("ji,jk,kl->il", T2, Fn_ref, T1, precision=_PREC)
    score_f, inl_F = _score_F(F_best, xy1, xy2, valid, inv_sigma2)

    # --- homography hypotheses ---------------------------------------
    Hn = _dlt_H(x1n[idx, :4], x2n[idx, :4])
    T2inv = jnp.linalg.inv(T2)
    Hm = jnp.einsum("ij,hjk,kl->hil", T2inv, Hn, T1, precision=_PREC)
    Hinv = jnp.linalg.inv(Hm + 1e-12 * jnp.eye(3))
    sH, okH = jax.vmap(
        lambda h, hi: _score_H(h, hi, xy1, xy2, valid, inv_sigma2)
    )(Hm, Hinv)
    bH = jnp.argmax(sH)
    inl_H = okH[bH]
    Hn_ref = _dlt_H(x1n, x2n, w=inl_H.astype(jnp.float32))
    H_best = jnp.einsum("ij,jk,kl->il", T2inv, Hn_ref, T1, precision=_PREC)
    score_h, inl_H = _score_H(
        H_best, jnp.linalg.inv(H_best + 1e-12 * jnp.eye(3)),
        xy1, xy2, valid, inv_sigma2,
    )

    rh = score_h / jnp.maximum(score_h + score_f, 1e-9)
    use_H = rh > 0.40  # Initializer.cc model selection

    # --- reconstruction candidates ------------------------------------
    K = cam.K
    Kinv = jnp.linalg.inv(K)

    # From F: E = K^T F K -> 4 (R, t) candidates.
    E = _mm(K.T, F_best, K)
    U, s_sv, V = linalg3.svd3x3(E)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    def fix_det(R):
        return R * jnp.sign(jnp.linalg.det(R))

    Ra = fix_det(_mm(U, W, V.T))
    Rb = fix_det(_mm(U, W.T, V.T))
    tu = U[:, 2]
    tu = tu / jnp.maximum(jnp.linalg.norm(tu), 1e-12)
    cand_F = (
        jnp.stack([Ra, Ra, Rb, Rb]),
        jnp.stack([tu, -tu, tu, -tu]),
    )

    # From H: Faugeras 8-solution decomposition of A = K^-1 H K
    # (ReconstructH, Initializer.cc:~650).
    A = _mm(Kinv, H_best, K)
    Ua, da, Va = linalg3.svd3x3(A)
    sdet = jnp.linalg.det(Ua) * jnp.linalg.det(Va)
    d1, d2, d3 = da[0], da[1], da[2]
    denom13 = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom13)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom13)
    x1s = jnp.asarray([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.asarray([1.0, -1.0, 1.0, -1.0]) * aux3
    eps13 = jnp.asarray([1.0, -1.0, 1.0, -1.0])

    # Case d' = +d2
    st = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)

    def mk_pos(i):
        sgn = eps13[i]
        Rp = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        Rp = Rp.at[0, 0].set(ct).at[2, 2].set(ct)
        Rp = Rp.at[0, 2].set(-sgn * st).at[2, 0].set(sgn * st)
        R = sdet * _mm(Ua, Rp, Va.T)
        tp = jnp.asarray([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = jnp.matmul(Ua, tp, precision=_PREC)
        return R, t

    # Case d' = -d2
    sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)

    def mk_neg(i):
        sgn = eps13[i]
        Rp = jnp.zeros((3, 3))
        Rp = Rp.at[0, 0].set(cp).at[1, 1].set(-1.0).at[2, 2].set(-cp)
        Rp = Rp.at[0, 2].set(sgn * sp).at[2, 0].set(sgn * sp)
        R = sdet * _mm(Ua, Rp, Va.T)
        tp = jnp.asarray([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = jnp.matmul(Ua, tp, precision=_PREC)
        return R, t

    Rs, ts = [], []
    for i in range(4):
        R_, t_ = mk_pos(i)
        Rs.append(R_); ts.append(t_)
    for i in range(4):
        R_, t_ = mk_neg(i)
        Rs.append(R_); ts.append(t_)
    cand_H = (jnp.stack(Rs), jnp.stack(ts))

    def norm_t(t):
        return t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)

    R_all = jnp.concatenate([cand_F[0], cand_H[0]])      # [12, 3, 3]
    t_all = norm_t(jnp.concatenate([cand_F[1], cand_H[1]]))
    # Only score the selected model's candidates.
    is_H_cand = jnp.arange(12) >= 4
    model_ok = jnp.where(use_H, is_H_cand, ~is_H_cand)
    inl = jnp.where(use_H, inl_H, inl_F)

    n_good, X_all, good_all, cospar = jax.vmap(
        lambda R, t: _check_rt(cam, R, t, xy1, xy2, inl, inv_sigma2)
    )(R_all, t_all)
    n_good = jnp.where(model_ok, n_good, -1)
    best = jnp.argmax(n_good)
    nb = n_good[best]
    # Uniqueness: the runner-up must be clearly worse (Initializer.cc:
    # nsimilar check — secondBest < 0.75 * best).
    second = jnp.max(jnp.where(jnp.arange(12) == best, -1, n_good))
    n_inl = jnp.sum(inl)
    ok = (
        (nb >= min_triangulated)
        & (nb > 0.5 * n_inl)
        & (0.75 * nb > jnp.maximum(second, 0))
    )
    return InitResult(
        ok=ok, used_H=use_H,
        R=R_all[best], t=t_all[best],
        X=X_all[best], good=good_all[best], n_good=nb,
        score_h=score_h, score_f=score_f,
    )
