"""Stereo correspondence for extracted features.

Replaces `Frame::ComputeStereoMatches` (ref:
corbslam_client/src/Frame.cc:470): for each left-image keypoint, find the
matching column in the right image along the same (rectified) row, giving
u_right and depth = bf / disparity.

Reference algorithm: per-row candidate lists of right keypoints, best
descriptor match within a disparity band, then an 11-px SAD slide of an
11x11 patch for sub-pixel refinement with parabola interpolation, then an
outlier cut at ~2x median SAD. Re-design, batched over all keypoints:

  1. candidate mask = |row difference| <= 2 px-at-octave AND disparity in
     [min_d, max_d]  ->  one masked Hamming matrix
  2. SAD refinement entirely on the keypoint-centered PATCHES already
     extracted by the ORB front end (ops/orb.py Features.patch) — static
     slices + elementwise ops, zero image gathers. The slide runs in the
     RIGHT keypoint's level pixels and is rescaled to level 0 (the
     reference slides at the left keypoint's octave, Frame.cc:540-560;
     same construction, level-aligned patches).
  3. validity: descriptor distance, disparity range, SAD-median cut.

`compute_stereo_from_rgbd` is the RGB-D analog (Frame.cc:647): fake
disparity from a depth map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import descriptors as D

PATCH_W = 5  # half-width of the SAD patch (11x11 like the reference)
SLIDE_R = 5  # +-5 px refinement slide (Frame.cc:552 L=5)


def match_stereo_features(
    fl,                       # ops.orb.Features (left)
    fr,                       # ops.orb.Features (right)
    scale_factors: jnp.ndarray,
    bf: float,
    max_disp: int = 192,
    max_hamming: int = 80,
):
    """Returns (u_right [N], depth [N], ok [N]) for left features.

    u_right < 0 marks monocular points (the reference convention,
    Frame.cc:644 mvuRight = -1). All coordinates are level-0 pixels.
    """
    xy_l, xy_r = fl.xy, fr.xy
    # 1. Row + disparity band candidate mask [Nl, Nr].
    row_tol = 2.0 * scale_factors[fr.octave]  # +-2 sigma rows (Frame.cc:508)
    d_row = jnp.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    mask = (d_row <= row_tol[None, :]) & (disp >= -1.0) & (disp <= float(max_disp))
    mask &= jnp.abs(fl.octave[:, None] - fr.octave[None, :]) <= 1
    mask &= fl.valid[:, None] & fr.valid[None, :]

    dmat = D.masked_hamming_matrix(fl.desc, fr.desc, extra_mask=mask)
    idx_r, dist, desc_ok = D.best_match(dmat, max_dist=max_hamming)
    safe_idx = jnp.clip(idx_r, 0)
    u_r0 = xy_r[safe_idx, 0]

    # 2. SAD subpixel refinement on the pre-extracted patches.
    C = fl.patch.shape[-1] // 2  # patch center
    right_sel = fr.patch[safe_idx]            # [K, P, P] row gather
    Lw = fl.patch[:, C - PATCH_W : C + PATCH_W + 1, C - PATCH_W : C + PATCH_W + 1]
    sads = []
    for s in range(-SLIDE_R, SLIDE_R + 1):
        Rw = right_sel[
            :, C - PATCH_W : C + PATCH_W + 1,
            C + s - PATCH_W : C + s + PATCH_W + 1,
        ]
        sads.append(jnp.sum(jnp.abs(Rw - Lw), axis=(1, 2)))
    sad = jnp.stack(sads, axis=-1)             # [K, 11]
    best = jnp.argmin(sad, axis=-1)
    best_in_range = jnp.clip(best, 1, 2 * SLIDE_R - 1)
    s0 = jnp.take_along_axis(sad, (best_in_range - 1)[:, None], 1)[:, 0]
    s1 = jnp.take_along_axis(sad, best_in_range[:, None], 1)[:, 0]
    s2 = jnp.take_along_axis(sad, (best_in_range + 1)[:, None], 1)[:, 0]
    denom = s0 + s2 - 2.0 * s1
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (s0 - s2) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    # Slide offset is in the right keypoint's LEVEL pixels; the patch slide
    # shifts the right window right by s, which moves the matched right
    # coordinate by +s level pixels.
    shift_lvl = (best_in_range - SLIDE_R).astype(jnp.float32) + delta
    u_right = u_r0 + shift_lvl * scale_factors[fr.octave[safe_idx]]

    disparity = xy_l[:, 0] - u_right
    ok = desc_ok & (disparity > 0.1) & (disparity < float(max_disp))
    # SAD outlier cut vs median of accepted (Frame.cc:620: 1.5f*1.4f*median)
    best_sad = s1
    med = jnp.median(jnp.where(ok, best_sad, jnp.nan))
    med = jnp.where(jnp.isnan(med), jnp.inf, med)
    ok &= best_sad <= 2.1 * med + 1e-3

    depth = jnp.where(ok, bf / jnp.maximum(disparity, 0.1), 0.0)
    u_right = jnp.where(ok, u_right, -1.0)
    return u_right, depth, ok


def compute_stereo_from_rgbd(
    depth_map: jnp.ndarray,
    xy: jnp.ndarray,
    valid: jnp.ndarray,
    bf: float,
    min_depth: float = 0.05,
    xy_und: jnp.ndarray | None = None,
):
    """Synthesize (u_right, depth) from a registered depth map —
    `Frame::ComputeStereoFromRGBD` (ref: Frame.cc:647): depth is read at the
    RAW keypoint but mvuRight is computed from the UNDISTORTED x, so the
    stored stereo residual stays consistent with the stored (undistorted)
    keypoint coords."""
    if xy_und is None:
        xy_und = xy
    h, w = depth_map.shape
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_map.reshape(-1)[yi * w + xi]  # flat gather
    ok = valid & (d > min_depth)
    u_right = jnp.where(ok, xy_und[:, 0] - bf / jnp.maximum(d, min_depth), -1.0)
    return u_right, jnp.where(ok, d, 0.0), ok
