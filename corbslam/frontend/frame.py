"""Per-frame construction: ORB extraction + stereo/RGB-D depth assignment.

The batched equivalent of the `Frame` constructors (ref:
corbslam_client/src/Frame.cc:61 stereo, :130 RGB-D, :188 mono): one jitted
program per camera geometry that turns raw images into the fixed-capacity
feature SoA used by tracking and mapping. The reference's 64x48 feature
grid (AssignFeaturesToGrid, Frame.cc:230) has no equivalent here — dense
masked matching replaced grid lookups (matching/matcher.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import OrbConfig
from ..geometry import camera as cam_mod
from ..ops import orb, stereo


class FrameData(NamedTuple):
    """Device-resident frame: features + stereo depth + matches + pose."""

    xy: jnp.ndarray       # [F, 2] undistorted level-0 coords
    octave: jnp.ndarray   # [F]
    angle: jnp.ndarray    # [F]
    desc: jnp.ndarray     # [F, 32]
    fvalid: jnp.ndarray   # [F]
    uright: jnp.ndarray   # [F] (-1 mono)
    depth: jnp.ndarray    # [F] (0 unknown)
    Tcw: jnp.ndarray      # [4, 4] estimated pose
    mp_idx: jnp.ndarray   # [F] matched map-point rows (NO_MP = -1)


def scale_tables(cfg: OrbConfig):
    s = jnp.asarray(cfg.scales(), jnp.float32)
    sigma2 = s * s
    return s, sigma2


@partial(jax.jit, static_argnames=("cfg", "cam"))
def build_frame_stereo(
    img_l: jnp.ndarray, img_r: jnp.ndarray, cam: cam_mod.Intrinsics, cfg: OrbConfig
) -> FrameData:
    fl = orb.extract(img_l, cfg)
    fr = orb.extract(img_r, cfg)
    scales, _ = scale_tables(cfg)
    uright, depth, _ = stereo.match_stereo_features(fl, fr, scales, float(cam.bf))
    xy_und = cam_mod.undistort_points(cam, fl.xy)
    F = fl.xy.shape[0]
    return FrameData(
        xy=xy_und, octave=fl.octave, angle=fl.angle, desc=fl.desc,
        fvalid=fl.valid, uright=uright, depth=depth,
        Tcw=jnp.eye(4), mp_idx=jnp.full(F, -1, jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg", "cam"))
def build_frame_rgbd(
    img: jnp.ndarray, depth_map: jnp.ndarray, cam: cam_mod.Intrinsics, cfg: OrbConfig
) -> FrameData:
    f = orb.extract(img, cfg)
    xy_und = cam_mod.undistort_points(cam, f.xy)
    uright, depth, _ = stereo.compute_stereo_from_rgbd(
        depth_map, f.xy, f.valid, float(cam.bf), xy_und=xy_und
    )
    F = f.xy.shape[0]
    return FrameData(
        xy=xy_und, octave=f.octave, angle=f.angle, desc=f.desc,
        fvalid=f.valid, uright=uright, depth=depth,
        Tcw=jnp.eye(4), mp_idx=jnp.full(F, -1, jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg", "cam"))
def build_frame_mono(
    img: jnp.ndarray, cam: cam_mod.Intrinsics, cfg: OrbConfig
) -> FrameData:
    f = orb.extract(img, cfg)
    xy_und = cam_mod.undistort_points(cam, f.xy)
    F = f.xy.shape[0]
    return FrameData(
        xy=xy_und, octave=f.octave, angle=f.angle, desc=f.desc,
        fvalid=f.valid,
        uright=jnp.full(F, -1.0, jnp.float32),
        depth=jnp.zeros(F, jnp.float32),
        Tcw=jnp.eye(4), mp_idx=jnp.full(F, -1, jnp.int32),
    )
