"""Per-keypoint pixel sampling for the ORB front end.

The reference samples per-keypoint pixels with pointer arithmetic
(`IC_Angle` ORBextractor.cc:77, `computeOrbDescriptor` :108,
`ComputeStereoMatches` Frame.cc:470). Here every pyramid level is
zero-padded by PAD pixels and flattened into ONE 1-D buffer, so the pixels
of every keypoint of every level are read by a single flat gather:
patches for the orientation moments and the stereo SAD, and the steered
BRIEF lookup table's samples (ops/brief.py). A gather selects stored values
exactly, so the samples are the same on every backend.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

# Zero border around each level. Must cover the largest sampling radius
# from a keypoint: rotated BRIEF reads up to +-19 (BRIEF_LIM), orientation
# +-15, the stereo SAD patch +-16.
PAD = 24


class FlatLevels(NamedTuple):
    """Zero-padded pyramid levels concatenated into one flat buffer."""

    data: jnp.ndarray     # [sum_l (h_l + 2 PAD) (w_l + 2 PAD)] f32
    offsets: np.ndarray   # [L] start of level l in `data` (static)
    widths: np.ndarray    # [L] padded row stride of level l (static)


def flatten_levels(levels: Sequence[jnp.ndarray]) -> FlatLevels:
    flat, offsets, widths, start = [], [], [], 0
    for img in levels:
        p = jnp.pad(img, PAD)
        flat.append(p.reshape(-1))
        offsets.append(start)
        widths.append(p.shape[1])
        start += p.size
    return FlatLevels(jnp.concatenate(flat), np.asarray(offsets, np.int32),
                      np.asarray(widths, np.int32))


def keypoint_index(fl: FlatLevels, octave: jnp.ndarray, yx: jnp.ndarray):
    """Flat index of each keypoint's pixel and its level's row stride.

    octave [K] i32, yx [K, 2] i32 level-pixel (row, col) -> (base [K],
    stride [K])."""
    stride = jnp.asarray(fl.widths)[octave]
    base = (jnp.asarray(fl.offsets)[octave]
            + (yx[:, 0] + PAD) * stride + (yx[:, 1] + PAD))
    return base, stride


def gather_offsets(fl: FlatLevels, base: jnp.ndarray, stride: jnp.ndarray,
                   dy: jnp.ndarray, dx: jnp.ndarray) -> jnp.ndarray:
    """Pixels at (dy, dx) from each keypoint; dy/dx broadcast against
    [K, ...] and stay within +-PAD."""
    extra = (1,) * (dy.ndim - 1)
    b = base.reshape(-1, *extra)
    s = stride.reshape(-1, *extra)
    return fl.data[b + dy * s + dx]


def gather_patches(fl: FlatLevels, base: jnp.ndarray, stride: jnp.ndarray,
                   out: int) -> jnp.ndarray:
    """[K, out, out] patches with the keypoint at (out//2, out//2)."""
    r = jnp.arange(out, dtype=jnp.int32) - out // 2
    return gather_offsets(fl, base, stride, r[None, :, None], r[None, None, :])
