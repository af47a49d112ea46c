"""Image pyramid + Gaussian blur.

Replaces `ORBextractor::ComputePyramid` (ref:
corbslam_client/src/ORBextractor.cc:1107 — per-level cv::resize +
cv::GaussianBlur(7x7, sigma=2) before descriptor sampling).

Bilinear resize is two matmuls against static two-tap weight matrices, at
full f32 precision. The blur is a separable 7-tap shift-and-add over static
slices. All shapes are static per
(H, W, n_levels) config, so each pyramid level is its own fixed-shape op
under one jit.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) sizes, mirroring inv_scale^level."""
    out = []
    for lvl in range(n_levels):
        s = 1.0 / (scale ** lvl)
        out.append((max(int(round(h * s)), 16), max(int(round(w * s)), 16)))
    return out


@lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation weights (align_corners=False,
    the half-pixel convention cv::resize / jax.image.resize use)."""
    x = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    i0 = np.clip(np.floor(x).astype(np.int32), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    f = np.clip(x - i0, 0.0, 1.0).astype(np.float32)
    R = np.zeros((n_out, n_in), np.float32)
    np.add.at(R, (np.arange(n_out), i0), 1.0 - f)
    np.add.at(R, (np.arange(n_out), i1), f)
    return R


def resize_bilinear(img: jnp.ndarray, out_hw) -> jnp.ndarray:
    """[H, W] -> [h, w] bilinear as two full-f32 matmuls: Ry @ img @ Rx^T."""
    h_in, w_in = img.shape
    h_out, w_out = out_hw
    Ry = jnp.asarray(_resize_matrix(h_out, h_in))
    Rx = jnp.asarray(_resize_matrix(w_out, w_in))
    hi = jax.lax.Precision.HIGHEST
    return jnp.dot(jnp.dot(Ry, img, precision=hi), Rx.T, precision=hi)


def gaussian_kernel_1d(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, size: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect padding, [H, W] f32.

    Shift-and-add form: 2*size fused multiply-adds over static slices of
    the padded image.
    """
    k = gaussian_kernel_1d(size, sigma)  # numpy: weights become constants
    pad = size // 2
    h, w = img.shape
    xp = jnp.pad(img, ((0, 0), (pad, pad)), mode="reflect")
    acc = k[0] * jax.lax.dynamic_slice_in_dim(xp, 0, w, axis=1)
    for i in range(1, size):
        acc = acc + k[i] * jax.lax.dynamic_slice_in_dim(xp, i, w, axis=1)
    yp = jnp.pad(acc, ((pad, pad), (0, 0)), mode="reflect")
    acc2 = k[0] * jax.lax.dynamic_slice_in_dim(yp, 0, h, axis=0)
    for i in range(1, size):
        acc2 = acc2 + k[i] * jax.lax.dynamic_slice_in_dim(yp, i, h, axis=0)
    return acc2


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float):
    """Returns (levels, blurred_levels): two lists of [h_l, w_l] f32 arrays.

    `levels` feed FAST detection; `blurred_levels` feed orientation/BRIEF
    sampling (the reference blurs only for descriptor computation,
    ORBextractor.cc:1026-1041).
    """
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = []
    for lvl, hw in enumerate(shapes):
        levels.append(img if lvl == 0 else resize_bilinear(levels[-1], hw))
    blurred = [gaussian_blur(x) for x in levels]
    return levels, blurred
