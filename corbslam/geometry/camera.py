"""Pinhole camera models: projection, unprojection, stereo, frustum tests.

Replaces the reference's scattered per-frame camera math (ref:
corbslam_client/src/Frame.cc:408 UndistortKeyPoints, Frame.cc:664
UnprojectStereo; Tracking.cc intrinsics parsing) with batched, broadcastable
functions over a small intrinsics struct.

All image coordinates follow the reference convention: ``u`` along columns
(x), ``v`` along rows (y), origin at the top-left pixel center.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

from . import se3


class Intrinsics(NamedTuple):
    """Pinhole + radial-tangential distortion + stereo baseline.

    ``bf`` is baseline*fx in pixels (the reference's ``mbf``); 0 for mono.
    ``dist`` is (k1, k2, p1, p2, k3) — zeros for pre-rectified input.

    Holds plain Python floats (hashable) so a camera can be a STATIC jit
    argument: intrinsics become compile-time constants in every program,
    and each camera geometry compiles exactly once.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    dist: tuple  # (k1, k2, p1, p2, k3)
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0, dist=None, width=1241, height=376):
        return Intrinsics(
            float(fx), float(fy), float(cx), float(cy), float(bf),
            (0.0,) * 5 if dist is None else tuple(float(d) for d in dist),
            int(width), int(height),
        )

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def K(self):
        return jnp.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            jnp.float32,
        )


def project(cam: Intrinsics, p_cam: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (no distortion)."""
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * p_cam[..., 1] * inv_z + cam.cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(cam: Intrinsics, p_cam: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3] = (u, v, u_right) with u_right = u - bf/z."""
    uv = project(cam, p_cam)
    z = p_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf * inv_z
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def backproject(cam: Intrinsics, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3].

    Equivalent of the reference's `Frame::UnprojectStereo` (Frame.cc:664).
    """
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def world_to_cam(Tcw: jnp.ndarray, p_world: jnp.ndarray) -> jnp.ndarray:
    return se3.transform(Tcw, p_world)


def cam_to_world(Tcw: jnp.ndarray, p_cam: jnp.ndarray) -> jnp.ndarray:
    return se3.transform(se3.inverse(Tcw), p_cam)


def distort(cam: Intrinsics, uv_norm: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_points(cam: Intrinsics, uv: jnp.ndarray, iters: int = 5) -> jnp.ndarray:
    """Undistort pixel coords by fixed-point iteration (batched).

    Equivalent of `Frame::UndistortKeyPoints` (Frame.cc:408), which calls
    cv::undistortPoints. Fixed iteration count keeps it jit-friendly.
    """
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy0 = jnp.stack([x0, y0], axis=-1)
    xy = xy0
    for _ in range(iters):
        d = distort(cam, xy) - xy
        xy = xy0 - d
    u = xy[..., 0] * cam.fx + cam.cx
    v = xy[..., 1] * cam.fy + cam.cy
    return jnp.stack([u, v], axis=-1)


def in_image(cam: Intrinsics, uv: jnp.ndarray, margin: float = 0.0) -> jnp.ndarray:
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )


def in_frustum(
    cam: Intrinsics,
    Tcw: jnp.ndarray,
    p_world: jnp.ndarray,
    min_dist: jnp.ndarray,
    max_dist: jnp.ndarray,
    normal: jnp.ndarray,
    view_cos_limit: float = 0.5,
):
    """Batched equivalent of `Frame::isInFrustum` (Frame.cc:305).

    Returns (visible_mask [..., ], uv [..., 2], inv_z [...], view_cos [...],
    dist [...]). Checks: positive depth, inside image, scale-distance band,
    viewing angle vs the point's mean normal.
    """
    p_cam = world_to_cam(Tcw, p_world)
    z = p_cam[..., 2]
    uv = project(cam, p_cam)
    cam_center = se3.translation(se3.inverse(Tcw))
    po = p_world - cam_center
    dist = jnp.linalg.norm(po, axis=-1)
    view_cos = jnp.sum(po * normal, axis=-1) / jnp.maximum(dist, 1e-9)
    ok = (
        (z > 0.0)
        & in_image(cam, uv)
        & (dist >= min_dist)
        & (dist <= max_dist)
        & (view_cos > view_cos_limit)
    )
    inv_z = 1.0 / jnp.maximum(z, 1e-9)
    return ok, uv, inv_z, view_cos, dist


def triangulate_linear(P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """DLT triangulation from two 3x4 projection matrices (batched over points).

    Equivalent of the reference's SVD triangulation in
    LocalMapping::CreateNewMapPoints (LocalMapping.cc:246-314) and
    Initializer::Triangulate (Initializer.cc:~). Solves A x = 0, A [4,4]
    via the eigenvector of A^T A with smallest eigenvalue (batched eigh —
    avoids per-point SVD of non-square matrices).
    """
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # [..., 4, 4]
    # Inhomogeneous least squares (w = 1): B x = -c with B = A[:, :3],
    # c = A[:, 3]. Solved via 3x3 normal equations + Cramer's rule — fully
    # fuseable elementwise math instead of a batched eigensolver, which lowers
    # to an enormous (and slow-to-compile) program. Finite points
    # only, which holds for every triangulation call site in the pipeline.
    B = A[..., :, :3]
    c = A[..., :, 3]
    G = jnp.matmul(jnp.swapaxes(B, -1, -2), B, precision=_PREC)  # [..., 3, 3]
    b = -jnp.einsum("...ij,...i->...j", B, c, precision=_PREC)
    return solve3x3(G, b)


def solve3x3(G: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cramer's-rule solve of batched 3x3 systems G x = b (elementwise ops
    only — cheap where batched LU/eigh lowerings are not)."""
    g00, g01, g02 = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
    g10, g11, g12 = G[..., 1, 0], G[..., 1, 1], G[..., 1, 2]
    g20, g21, g22 = G[..., 2, 0], G[..., 2, 1], G[..., 2, 2]
    c00 = g11 * g22 - g12 * g21
    c01 = g12 * g20 - g10 * g22
    c02 = g10 * g21 - g11 * g20
    det = g00 * c00 + g01 * c01 + g02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    c10 = g02 * g21 - g01 * g22
    c11 = g00 * g22 - g02 * g20
    c12 = g01 * g20 - g00 * g21
    c20 = g01 * g12 - g02 * g11
    c21 = g02 * g10 - g00 * g12
    c22 = g00 * g11 - g01 * g10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def projection_matrix(cam: Intrinsics, Tcw: jnp.ndarray) -> jnp.ndarray:
    """K [R|t]: [..., 3, 4]."""
    Rt = jnp.concatenate([se3.rotation(Tcw), se3.translation(Tcw)[..., :, None]], axis=-1)
    return jnp.matmul(cam.K, Rt, precision=_PREC)
