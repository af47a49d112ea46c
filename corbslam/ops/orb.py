"""Full ORB feature extractor: pyramid -> FAST -> orientation -> BRIEF.

The batched equivalent of `ORBextractor::operator()` (ref:
corbslam_client/src/ORBextractor.cc:1043): one jitted program per image
geometry that produces a fixed-capacity keypoint set across all pyramid
levels. Output coordinates are in level-0 pixels (the reference rescales by
`scale` at ORBextractor.cc:1097-1100).

Structure:
  per level:  FAST score -> NMS -> per-cell winners
  all levels: one flat buffer of the padded raw levels and one of the
              blurred levels (ops/patches.py); one gather cuts every
              keypoint's raw patch (orientation moments, stereo SAD) and one
              reads every keypoint's steered-BRIEF samples.

Returned `Features` is a flat SoA batch — the device-resident form of the
reference's vector<cv::KeyPoint> + descriptor Mat. `patch` holds the raw
keypoint-centered patch per feature (feeds stereo SAD refinement without
re-touching the image).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import OrbConfig
from . import brief, fast, patches, pyramid

RAW_PATCH = 32   # raw-image patch (orientation moments + stereo SAD)


class Features(NamedTuple):
    xy: jnp.ndarray        # [N, 2] f32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # [N] f32 FAST score
    angle: jnp.ndarray     # [N] f32 radians
    octave: jnp.ndarray    # [N] i32 pyramid level
    desc: jnp.ndarray      # [N, 32] u8 packed BRIEF-256
    valid: jnp.ndarray     # [N] bool
    patch: jnp.ndarray     # [N, RAW_PATCH, RAW_PATCH] f32 raw patch (level px)

    @property
    def n(self):
        return self.xy.shape[0]


def extract(img: jnp.ndarray, cfg: OrbConfig) -> Features:
    """img [H, W] f32 (grayscale, 0..255) -> Features with capacity
    sum(features_per_level) == cfg.n_features."""
    levels, blurred = pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = cfg.features_per_level()
    scales = cfg.scales()

    xy0s, yxs, resps, valids, octaves = [], [], [], [], []
    for lvl in range(cfg.n_levels):
        det = fast.detect_cells(
            levels[lvl], cfg.ini_th_fast, cfg.cell_size, budgets[lvl],
            cfg.min_th_fast,
        )
        xy0s.append(det["xy"] * scales[lvl])
        yxs.append(det["xy"][:, ::-1].astype(jnp.int32))
        resps.append(det["resp"])
        valids.append(det["valid"])
        octaves.append(jnp.full(budgets[lvl], lvl, jnp.int32))

    xy = jnp.concatenate(xy0s)
    resp = jnp.concatenate(resps)
    valid = jnp.concatenate(valids)
    octave = jnp.concatenate(octaves)
    yx = jnp.concatenate(yxs)

    raw = patches.flatten_levels(levels)
    base, stride = patches.keypoint_index(raw, octave, yx)
    raw_patch = patches.gather_patches(raw, base, stride, RAW_PATCH)
    angle = brief.orientation_from_patches(raw_patch)
    desc = brief.brief_from_levels(
        patches.flatten_levels(blurred), base, stride, angle)
    return Features(xy, resp, angle, octave, desc, valid, raw_patch)


@partial(jax.jit, static_argnames=("cfg",))
def extract_jit(img: jnp.ndarray, cfg: OrbConfig) -> Features:
    return extract(img, cfg)
