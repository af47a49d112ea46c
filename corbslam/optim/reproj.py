"""Reprojection residuals + analytic Jacobians (mono & stereo, batched).

The batched form of g2o's edge types `EdgeSE3ProjectXYZ` /
`EdgeStereoSE3ProjectXYZ` (ref:
corbslam_client/Thirdparty/g2o/g2o/types/types_six_dof_expmap.h): residual
r = z - h(T, X) with h the (stereo) pinhole projection, and closed-form
Jacobians w.r.t. the camera's se3 tangent (left-multiplicative update
exp(xi) @ Tcw) and the world point.

Everything is a flat batch over observations: [K] cameras indices are NOT
handled here — callers gather poses/points per observation and segment-sum
the products (optim/ba.py). All residuals are 3-vectors; monocular
observations zero the third (u_right) weight, which keeps one fused kernel
for both edge types instead of two programs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3

_PREC = jax.lax.Precision.HIGHEST

# Chi2 95% quantiles used everywhere by the reference (Optimizer.cc:419-420,
# 717-718): 2-DoF (mono) and 3-DoF (stereo).
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Residuals(NamedTuple):
    r: jnp.ndarray        # [K, 3] residual (u, v, uR); third row 0 for mono
    J_pose: jnp.ndarray   # [K, 3, 6] d r / d xi (camera tangent)
    J_point: jnp.ndarray  # [K, 3, 3] d r / d X_world
    w: jnp.ndarray        # [K, 3] per-row weights (invSigma2, 0 third row mono)
    depth_ok: jnp.ndarray # [K] positive-depth mask


def observation_weights(inv_sigma2: jnp.ndarray, is_stereo: jnp.ndarray) -> jnp.ndarray:
    """[K] -> [K, 3] row weights; mono zeroes the u_right row."""
    w3 = jnp.where(is_stereo, inv_sigma2, 0.0)
    return jnp.stack([inv_sigma2, inv_sigma2, w3], axis=-1)


def linearize(
    cam: cam_mod.Intrinsics,
    Tcw: jnp.ndarray,       # [K, 4, 4] pose per observation (pre-gathered)
    X: jnp.ndarray,         # [K, 3] world point per observation
    obs: jnp.ndarray,       # [K, 3] measured (u, v, uR); uR ignored for mono
    inv_sigma2: jnp.ndarray,  # [K]
    is_stereo: jnp.ndarray,   # [K] bool
) -> Residuals:
    """Residuals + Jacobians at the current linearization point."""
    R = se3.rotation(Tcw)
    p = jnp.einsum("kij,kj->ki", R, X, precision=_PREC) + se3.translation(Tcw)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    depth_ok = z > 1e-3
    zs = jnp.where(depth_ok, z, 1.0)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    pred = jnp.stack([u, v, ur], axis=-1)
    r = obs - pred

    # A = d(pred)/d(p_cam): [K, 3, 3]
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    zero = jnp.zeros_like(x)
    A = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], -1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], -1),
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], -1),
        ],
        axis=-2,
    )
    # B = d(p_cam)/d(xi) for left-mult update: [I | -hat(p_cam)]  [K, 3, 6]
    B = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), A.shape), -se3.hat(p)], axis=-1
    )
    # r = obs - pred => dr/d* = -A @ (d p / d*)
    J_pose = -jnp.einsum("kij,kjl->kil", A, B, precision=_PREC)
    J_point = -jnp.einsum("kij,kjl->kil", A, R, precision=_PREC)

    w = observation_weights(inv_sigma2, is_stereo)
    w = w * depth_ok[:, None]
    return Residuals(r, J_pose, J_point, w, depth_ok)


def chi2(res_r: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted squared error per observation: [K, 3], [K, 3] -> [K]."""
    return jnp.sum(res_r * res_r * w, axis=-1)


def chi2_threshold(is_stereo: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)


def huber_weights(c2: jnp.ndarray, delta2: jnp.ndarray) -> jnp.ndarray:
    """IRLS Huber weight from chi2 (g2o RobustKernelHuber equivalent):
    w = 1 for chi2 <= delta^2, else delta/sqrt(chi2)."""
    safe = jnp.maximum(c2, 1e-12)
    return jnp.where(c2 <= delta2, 1.0, jnp.sqrt(delta2 / safe))
