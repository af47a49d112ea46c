"""Keypoint orientation (intensity centroid) + rotated BRIEF descriptors.

Replaces `IC_Angle` (ref: corbslam_client/src/ORBextractor.cc:77 — circular
patch moments m01/m10 over a radius-15 patch) and `computeOrbDescriptor`
(ORBextractor.cc:108 — 256 learned point pairs rotated by the keypoint
angle). The sampling pattern here is NOT the reference's learned
`bit_pattern_31_` table; it is an independently generated isotropic Gaussian
pair pattern (original-BRIEF style, Calonder et al. 2010), fixed by seed at
import. Descriptors are self-consistent within this framework, which is all
the pipeline requires.

Batched over keypoints: patch reads become one XLA gather of
[K, n_samples] pixels — no per-keypoint loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import patches
from .descriptors import pack_bits

PATCH_RADIUS = 15  # orientation patch, matches reference HALF_PATCH_SIZE
BRIEF_RADIUS = 13  # pattern coords within +/-13 so rotations stay in 31x31... (see pad)
N_BITS = 256


def _circular_offsets(radius: int) -> np.ndarray:
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    mask = ys * ys + xs * xs <= radius * radius
    return np.stack([ys[mask], xs[mask]], axis=-1).astype(np.int32)  # [P, 2]


_ORIENT_OFFS = _circular_offsets(PATCH_RADIUS)


def _make_pattern(seed: int = 42) -> np.ndarray:
    """[256, 2, 2] int32 (pair, point, (y, x)) ~ N(0, (r/2.5)^2), clipped."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, BRIEF_RADIUS / 2.5, size=(N_BITS, 2, 2))
    return np.clip(np.round(pts), -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.int32)


BRIEF_PATTERN = _make_pattern()


def _gather_pixels(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """Clamped gather: img [H, W], ys/xs [...] -> [...] f32."""
    h, w = img.shape
    ys = jnp.clip(ys, 0, h - 1)
    xs = jnp.clip(xs, 0, w - 1)
    return img.reshape(-1)[ys * w + xs]


def compute_orientation(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle for keypoints.

    img [H, W] f32, xy [K, 2] f32 (x, y) -> angle [K] radians.
    theta = atan2(m01, m10) over the circular radius-15 patch (IC_Angle).
    """
    kx = jnp.round(xy[:, 0]).astype(jnp.int32)
    ky = jnp.round(xy[:, 1]).astype(jnp.int32)
    offs = jnp.asarray(_ORIENT_OFFS)  # [P, 2]
    ys = ky[:, None] + offs[None, :, 0]
    xs = kx[:, None] + offs[None, :, 1]
    vals = _gather_pixels(img, ys, xs)  # [K, P]
    m01 = jnp.sum(vals * offs[None, :, 0].astype(jnp.float32), axis=1)
    m10 = jnp.sum(vals * offs[None, :, 1].astype(jnp.float32), axis=1)
    return jnp.arctan2(m01, m10)


def compute_brief(
    img: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray
) -> jnp.ndarray:
    """Rotated BRIEF-256. img (blurred) [H, W], xy [K, 2], angle [K] ->
    packed descriptors uint8 [K, 32].

    Pattern points are rotated by the keypoint angle and rounded — the
    steered-BRIEF construction of computeOrbDescriptor (ORBextractor.cc:108).
    """
    pat = jnp.asarray(BRIEF_PATTERN, jnp.float32)  # [256, 2, 2] (y, x)
    c, s = jnp.cos(angle), jnp.sin(angle)  # [K]
    py, px = pat[..., 0], pat[..., 1]  # [256, 2]
    # Rotate: x' = x cos - y sin ; y' = x sin + y cos
    rx = px[None] * c[:, None, None] - py[None] * s[:, None, None]
    ry = px[None] * s[:, None, None] + py[None] * c[:, None, None]
    kx = jnp.round(xy[:, 0])[:, None, None]
    ky = jnp.round(xy[:, 1])[:, None, None]
    ys = jnp.round(ky + ry).astype(jnp.int32)  # [K, 256, 2]
    xs = jnp.round(kx + rx).astype(jnp.int32)
    vals = _gather_pixels(img, ys, xs)  # [K, 256, 2]
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)  # [K, 256]
    return pack_bits(bits)


# ---------------------------------------------------------------------------
# Forms used by ops/orb.py. `compute_orientation` / `compute_brief` above
# remain the semantic reference (and serve ad-hoc single-keypoint use); the
# forms below read pixels through ops/patches.py's flat level buffer.
# ---------------------------------------------------------------------------

N_ANGLE_BINS = 16  # rotated-BRIEF steering quantization (22.5 deg steps)
BRIEF_LIM = 19     # rotated pattern offsets are clipped to +-BRIEF_LIM


def _orientation_weights(patch: int) -> np.ndarray:
    """[patch*patch, 2] moment weights (m01: dy, m10: dx) over the circular
    radius-15 patch, keypoint at (patch//2, patch//2) — IC_Angle's moments."""
    c = patch // 2
    ys, xs = np.mgrid[0:patch, 0:patch]
    dy = (ys - c).astype(np.float32)
    dx = (xs - c).astype(np.float32)
    mask = (dy * dy + dx * dx <= PATCH_RADIUS * PATCH_RADIUS).astype(np.float32)
    return np.stack([(dy * mask).reshape(-1), (dx * mask).reshape(-1)], axis=-1)


def brief_table(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """[n_bins, 256, 2, 2] int32 (bin, pair, endpoint, (dy, dx)) offsets.

    The steered-BRIEF lookup table: the pattern rotated by bin angle
    2*pi*b/n_bins, rounded, and clipped to +-BRIEF_LIM.
    """
    pat = BRIEF_PATTERN.astype(np.float32)  # [256, 2, 2] (pair, pt, (y, x))
    py, px = pat[..., 0], pat[..., 1]       # [256, 2]
    out = np.zeros((n_bins, N_BITS, 2, 2), np.int32)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        cth, sth = np.cos(th), np.sin(th)
        out[b, ..., 1] = np.clip(np.round(px * cth - py * sth), -BRIEF_LIM, BRIEF_LIM)
        out[b, ..., 0] = np.clip(np.round(px * sth + py * cth), -BRIEF_LIM, BRIEF_LIM)
    return out


def angle_bin(angle: jnp.ndarray, n_bins: int = N_ANGLE_BINS) -> jnp.ndarray:
    """[K] radians -> [K] i32 steering bin (nearest multiple of 2*pi/n_bins)."""
    two_pi = 2.0 * jnp.pi
    return jnp.round((angle % two_pi) / two_pi * n_bins).astype(jnp.int32) % n_bins


def orientation_from_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """[K, P, P] raw-image patches (keypoint centered) -> angle [K] rad."""
    K, P, _ = patches.shape
    w = jnp.asarray(_orientation_weights(P))
    m = jnp.dot(
        patches.reshape(K, P * P), w,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [K, 2] = (m01, m10)
    return jnp.arctan2(m[:, 0], m[:, 1])


def brief_from_levels(fl, base: jnp.ndarray, stride: jnp.ndarray,
                      angle: jnp.ndarray) -> jnp.ndarray:
    """Binned steered BRIEF over BLURRED levels -> packed uint8 [K, 32].

    `fl`, `base`, `stride` locate each keypoint in the flat level buffer
    (ops/patches.py). Each keypoint reads the 512 pixels of its angle bin's
    row of `brief_table`. Self-consistent across the framework: every
    descriptor is produced by this same quantization.
    """
    tab = jnp.asarray(brief_table())[angle_bin(angle)]       # [K, 256, 2, 2]
    samp = patches.gather_offsets(fl, base, stride, tab[..., 0], tab[..., 1])
    bits = (samp[..., 0] < samp[..., 1]).astype(jnp.uint8)  # [K, 256]
    return pack_bits(bits)
