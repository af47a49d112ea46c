"""FAST-9/16 corner detection as dense vectorized ops.

Replaces the reference's per-cell cv::FAST calls in
`ORBextractor::ComputeKeyPointsOctTree` (ref:
corbslam_client/src/ORBextractor.cc:765 — 30x30 cells, iniThFAST=20 falling
back to minThFAST=7) with a whole-image score map: for every pixel compute
the FAST segment-test corner score (the classic "max over the 16 circular
arcs of the min absolute center difference"), then 3x3 NMS. Instead of the
reference's quad-tree `DistributeOctTree` (ORBextractor.cc:539), spatial
spreading uses per-cell argmax + global top-k over cells — a data-parallel
equivalent with the same intent (even keypoint coverage), no pointer
chasing.

Everything here operates on [H, W] f32 maps and is fully fuseable by XLA:
the 16 ring reads are static slices of one zero-padded image, the
windowed arc min/max is a log-depth tree reduction, and selection is
per-cell argmax + one top-k.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 — the 16 FAST offsets (row, col), clockwise.
# Public constant geometry of the FAST detector (Rosten & Drummond 2006).
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9


def fast_score_map(img: jnp.ndarray, threshold: float, border: int = 16) -> jnp.ndarray:
    """FAST-9 corner score per pixel. img [H, W] f32 -> score [H, W] f32.

    Score = max over the 16 contiguous 9-arcs of min_i (d_i - t) for bright
    arcs and min_i (-d_i - t) for dark arcs, clipped at 0 — i.e. "by how much
    does the weakest pixel of the best arc clear the threshold". Zero means
    not a corner. Pixels within `border` of the edge are zeroed — default 16
    matching the reference's descriptor-safe detection margin
    (EDGE_THRESHOLD-3, ORBextractor.cc:765 minBorderX).
    """
    h, w = img.shape
    center = img
    # Ring reads as static slices of a 3-px zero-padded image (cheaper than
    # jnp.roll's concat pairs; borders are masked out below anyway).
    padded = jnp.pad(img, 3)
    ring = jnp.stack(
        [
            jax.lax.dynamic_slice(padded, (3 + int(dy), 3 + int(dx)), (h, w))
            for dy, dx in FAST_OFFSETS
        ],
        axis=0,
    )  # [16, H, W]
    d = ring - center[None]  # [16, H, W]

    # Windowed circular min over 9 consecutive ring positions.
    # min_window[s] = min(d[s], d[s+1], ..., d[s+8])  (mod 16)
    dd = jnp.concatenate([d, d[: ARC_LEN - 1]], axis=0)  # [24, H, W]
    # Tree reduction: 9 = 8 + 1 -> log steps
    m = dd
    m = jnp.minimum(m[:-1], m[1:])          # window 2
    m = jnp.minimum(m[:-2], m[2:])          # window 4
    m = jnp.minimum(m[:-4], m[4:])          # window 8
    bright_min = jnp.minimum(m[:16], dd[8:24])  # window 9: min(win8[s], d[s+8])

    M = dd
    M = jnp.maximum(M[:-1], M[1:])
    M = jnp.maximum(M[:-2], M[2:])
    M = jnp.maximum(M[:-4], M[4:])
    dark_max = jnp.maximum(M[:16], dd[8:24])

    bright_score = jnp.max(bright_min, axis=0) - threshold  # >0 => corner
    dark_score = -jnp.min(dark_max, axis=0) - threshold
    score = jnp.maximum(jnp.maximum(bright_score, dark_score), 0.0)

    # Zero the border (ring reads hit the zero pad; descriptors need margin).
    b = max(border, 3)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return jnp.where(interior, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep scores that are the strict max of their 3x3 neighborhood."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


def select_keypoints_cells(score: jnp.ndarray, cell: int, max_kp: int):
    """Spatially-spread keypoint selection: per-cell argmax + global top-k.

    The data-parallel stand-in for `DistributeOctTree` (ORBextractor.cc:539):
    the image is tiled into `cell`x`cell` boxes, the best corner of each box
    survives, and the `max_kp` best boxes win. Guarantees at most one
    keypoint per cell => even spatial coverage.

    Returns a dict with per-winner arrays of length max_kp:
      xy [max_kp, 2] f32 (x, y) in level pixels, resp, valid.
    """
    h, w = score.shape
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    H, W = h + ph, w + pw
    gy, gx = H // cell, W // cell
    tiles = s.reshape(gy, cell, gx, cell).transpose(0, 2, 1, 3).reshape(gy * gx, cell * cell)
    best_in_cell = jnp.argmax(tiles, axis=1)
    best_val = jnp.max(tiles, axis=1)

    k = min(max_kp, gy * gx)
    top_val, top_cell = jax.lax.top_k(best_val, k)
    cy = top_cell // gx
    cx = top_cell % gx
    inside = best_in_cell[top_cell]
    iy = inside // cell
    ix = inside % cell
    y = cy * cell + iy
    x = cx * cell + ix
    valid = top_val > 0.0
    xy = jnp.stack([x, y], axis=-1).astype(jnp.float32)
    if k < max_kp:
        pad = max_kp - k
        xy = jnp.concatenate([xy, jnp.zeros((pad, 2), jnp.float32)])
        top_val = jnp.concatenate([top_val, jnp.zeros(pad, top_val.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    return {"xy": xy, "resp": top_val, "valid": valid}


@partial(jax.jit, static_argnames=("cell", "max_kp"))
def select_keypoints_grid(score: jnp.ndarray, cell: int, max_kp: int):
    """Back-compat wrapper: (xy, resp, valid) of select_keypoints_cells."""
    d = select_keypoints_cells(score, cell, max_kp)
    return d["xy"], d["resp"], d["valid"]


def detect(
    img: jnp.ndarray,
    threshold: float,
    cell: int,
    max_kp: int,
    min_threshold: float | None = None,
):
    """FAST + NMS + grid selection on one pyramid level.

    `min_threshold` mirrors the reference's two-tier thresholds
    (iniThFAST=20 / minThFAST=7, ORBextractor.cc:793-812): the score map is
    computed at the low threshold, but cells whose best clears the high
    threshold get a score bonus so strong corners win cell slots first.
    """
    lo = threshold if min_threshold is None else min_threshold
    score = fast_score_map(img, lo)
    score = nms3x3(score)
    return select_keypoints_grid(score, cell, max_kp)


def detect_cells(
    img: jnp.ndarray,
    threshold: float,
    cell: int,
    max_kp: int,
    min_threshold: float | None = None,
):
    """Like `detect` but returns the dict of `select_keypoints_cells`."""
    lo = threshold if min_threshold is None else min_threshold
    score = fast_score_map(img, lo)
    score = nms3x3(score)
    return select_keypoints_cells(score, cell, max_kp)
