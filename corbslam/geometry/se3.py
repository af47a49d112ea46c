"""Batched SE(3) Lie-group operations.

Replaces the reference's Eigen/g2o `SE3Quat` + `Converter` utilities
(ref: corbslam_client/Thirdparty/g2o/g2o/types/se3quat.h,
corbslam_client/src/Converter.cc) with pure-functional, broadcastable JAX
transforms. Poses are stored as 4x4 homogeneous matrices `T` with leading
batch dimensions; tangent vectors are `[..., 6]` with layout
``(rho, phi) = (translation, rotation)``.

Everything here is jit/vmap-friendly: no data-dependent control flow, small-
angle branches handled with `jnp.where` on Taylor expansions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Accelerator f32 matmuls default to reduced-precision passes (TF32 on
# the GPU); geometry needs full f32.
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)

_EPS = 1e-8


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator. phi: [..., 3] -> [..., 3, 3] skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat. M: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jnp.ndarray):
    """Stable A=sin(t)/t, B=(1-cos t)/t^2, C=(t-sin t)/t^3 from theta^2.

    Denominators are sanitized INSIDE the untaken branch (not just masked by
    `where`) so reverse-mode AD through the small-angle case stays NaN-free:
    `where` hides a 0/0 forward value but not its cotangent.
    """
    small = theta2 < 1e-8
    t2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(t2_safe)
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / t2_safe)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / t2_safe)
    return A, B, C


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    A, B, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return I + A[..., None, None] * K + B[..., None, None] * _mm(K, K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle, [..., 3, 3] -> [..., 3].

    Handles theta near 0 and near pi (via the symmetric-part fallback).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # sin(theta) * axis

    # Gradient-safe theta/scale: arccos'(1) = inf, so the small-angle branch
    # must never see cos_t ~ 1 even in its UNTAKEN arccos (autodiff pulls
    # cotangents through untaken where-branches). Small branch is the smooth
    # series scale = theta/sin(theta) ~ 1 + (1 - cos)/3 in cos_t directly.
    small = cos_t > 1.0 - 1e-6
    cos_gen = jnp.where(small, 0.5, cos_t)
    theta_gen = jnp.arccos(cos_gen)
    theta = jnp.where(small, jnp.sqrt(jnp.maximum(2.0 * (1.0 - cos_t), 1e-24)), theta_gen)
    scale = jnp.where(
        small,
        1.0 + (1.0 - cos_t) / 3.0,
        theta_gen / jnp.maximum(jnp.sin(theta_gen), _EPS),
    )
    phi_generic = scale[..., None] * w

    # Near pi: axis from diagonal of (R + I)/2 = axis axis^T cos-corrected
    # R = I + sin t K + (1-cos t) K^2 ; at t=pi: R = I + 2 K^2 => (R+I)/2 has
    # diagonal axis_i^2. Recover magnitudes then fix signs from off-diagonals.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - cos_t[..., None]) / jnp.maximum(1.0 - cos_t[..., None], _EPS), 0.0)
    axis = jnp.sqrt(jnp.maximum(axis2, 1e-24))  # sqrt'(0)=inf guard for AD
    # Sign fix: choose the largest component positive, then use off-diagonal
    # sums (R+R^T)/2 off-diagonals = (1-cos) a_i a_j to sign the rest.
    Rsym = (R + jnp.swapaxes(R, -1, -2)) * 0.5
    k = jnp.argmax(axis2, axis=-1)
    offd = jnp.stack(
        [
            jnp.stack([axis2[..., 0], Rsym[..., 0, 1], Rsym[..., 0, 2]], axis=-1),
            jnp.stack([Rsym[..., 1, 0], axis2[..., 1], Rsym[..., 1, 2]], axis=-1),
            jnp.stack([Rsym[..., 2, 0], Rsym[..., 2, 1], axis2[..., 2]], axis=-1),
        ],
        axis=-2,
    )
    row = jnp.take_along_axis(offd, k[..., None, None].repeat(3, axis=-1), axis=-2)[..., 0, :]
    signs = jnp.sign(jnp.where(jnp.abs(row) < _EPS, 1.0, row))
    axis_pi = axis * signs
    axis_pi = axis_pi / jnp.maximum(jnp.linalg.norm(axis_pi, axis=-1, keepdims=True), _EPS)
    # The construction above fixes signs only up to a global flip; for
    # theta < pi, sin(theta) >= 0 so dot(w, axis) >= 0 picks the right one
    # (at exactly pi both signs represent the same rotation).
    dot_w = jnp.sum(axis_pi * w, axis=-1, keepdims=True)
    axis_pi = jnp.where(dot_w < 0.0, -axis_pi, axis_pi)
    phi_pi = theta[..., None] * axis_pi

    near_pi = (theta > 3.0)[..., None]
    return jnp.where(near_pi, phi_pi, phi_generic)


def left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V: exp(xi)_trans = V @ rho."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    _, B, C = _sinc_coeffs(theta2)
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return I + B[..., None, None] * K + C[..., None, None] * _mm(K, K)


def left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    K = hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    half_theta = 0.5 * theta
    cot = jnp.where(
        theta2 < 1e-8,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), _EPS)) / jnp.maximum(theta2, _EPS),
    )
    return I - 0.5 * K + cot[..., None, None] * _mm(K, K)


# ---------------------------------------------------------------------------
# SE(3) as 4x4 matrices
# ---------------------------------------------------------------------------

def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch_shape) + (4, 4))


def from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_Rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_PREC))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return _mm(A, B)


def transform(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply [..., 4, 4] to points [..., 3] (broadcasting)."""
    return jnp.einsum("...ij,...j->...i", rotation(T), p, precision=_PREC) + translation(T)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exp. xi: [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho, precision=_PREC)
    return from_Rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 4] -> [..., 6] (rho, phi)."""
    phi = so3_log(rotation(T))
    Vinv = left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, translation(T), precision=_PREC)
    return jnp.concatenate([rho, phi], axis=-1)


def retract(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative update exp(xi) @ T (the BA update convention)."""
    return compose(exp(xi), T)


def orthonormalize_fast(T: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Project the rotation block toward SO(3) with the Newton polar
    iteration R <- R (3I - R^T R) / 2 (quadratic convergence for singular
    values in (0, sqrt(3))) — no SVD, 2 small matmuls per step.

    WHY THIS EXISTS: `inverse` uses R^T as R^-1. For a slightly
    non-orthonormal R = (I+E)Q that transposes the error instead of
    inverting it, so each velocity/predict round trip
    (T_cur ∘ T_prev^-1 ∘ T_prev ...) DOUBLES the symmetric part of E —
    per-frame f32 rounding (~1e-7) compounds exponentially (~2.5x/frame
    measured) and destroyed stored keyframe rotations within ~150 frames.
    Every program that WRITES a pose must renormalize through this."""
    R = rotation(T)
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), R.shape)
    for _ in range(iters):
        R = 0.5 * _mm(R, 3.0 * I - _mm(jnp.swapaxes(R, -1, -2), R))
    return from_Rt(R, translation(T))


def orthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation block back onto SO(3) via SVD (numerics guard)."""
    R = rotation(T)
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(_mm(U, Vt))
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]],
        axis=-1,
    )
    Rn = _mm(U, D[..., :, None] * Vt)
    return from_Rt(Rn, translation(T))


# ---------------------------------------------------------------------------
# Quaternions (wxyz), for compact [N, 7] storage and trajectory export
# ---------------------------------------------------------------------------

def quat_from_R(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z). Branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    # Four candidate constructions; pick the best-conditioned.
    qw = jnp.sqrt(jnp.maximum(1.0 + m00 + m11 + m22, 0.0)) * 0.5
    qx = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) * 0.5
    qy = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0)) * 0.5
    qz = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0)) * 0.5
    c0 = jnp.stack([qw, (m21 - m12) / (4 * qw + _EPS), (m02 - m20) / (4 * qw + _EPS), (m10 - m01) / (4 * qw + _EPS)], -1)
    c1 = jnp.stack([(m21 - m12) / (4 * qx + _EPS), qx, (m01 + m10) / (4 * qx + _EPS), (m02 + m20) / (4 * qx + _EPS)], -1)
    c2 = jnp.stack([(m02 - m20) / (4 * qy + _EPS), (m01 + m10) / (4 * qy + _EPS), qy, (m12 + m21) / (4 * qy + _EPS)], -1)
    c3 = jnp.stack([(m10 - m01) / (4 * qz + _EPS), (m02 + m20) / (4 * qz + _EPS), (m12 + m21) / (4 * qz + _EPS), qz], -1)
    mags = jnp.stack([qw, qx, qy, qz], axis=-1)
    best = jnp.argmax(mags, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # [..., 4cand, 4]
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def R_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion [..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )
