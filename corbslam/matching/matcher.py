"""Batched descriptor search policies.

The batched re-design of `ORBmatcher` (ref: corbslam_client/src/ORBmatcher.cc,
1810 LoC of per-keypoint loops over grid cells / BoW nodes / epipolar
bands). Every search policy here has the same shape:

    1. build a dense [M, N] candidacy MASK (projection window, epipolar
       band, scale-octave compatibility, area window, ...),
    2. one masked Hamming matrix,
    3. best-match + Lowe-ratio + mutual-uniqueness reduction,
    4. optional rotation-consistency histogram filter.

The reference prunes candidates with pointer structures (64x48 feature grid
Frame.cc:230, BoW FeatureVector nodes, quad-tree); on an accelerator computing all M*N
distances and masking is faster than any of that — a 2048x2048x256-bit
distance matrix is one dense op.

Search policies covered (ref ORBmatcher.h:48-84):
  - search_by_projection_points   (frame<-map points; Tracking + reloc widen)
  - search_frame_frame            (motion-model frame<-last frame)
  - search_for_initialization     (area windows, monocular init)
  - search_for_triangulation      (epipolar band between two KFs)
  - search_by_sim3 / fuse         (see mapping/ and collab/ call sites)
  - search_by_descriptor          (BoW-free global best: reloc & fusion)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import descriptors as D

_HI = jax.lax.Precision.HIGHEST

NO_MATCH = -1


class MatchResult(NamedTuple):
    idx: jnp.ndarray   # [N] index into the other set, NO_MATCH if none
    dist: jnp.ndarray  # [N] Hamming distance (INF_DIST when no match)
    ok: jnp.ndarray    # [N] bool


def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    ok: jnp.ndarray,
    n_bins: int = 30,
    keep_top: int = 3,
) -> jnp.ndarray:
    """Keep matches whose angle difference falls in the `keep_top` most
    popular histogram bins — `ComputeThreeMaxima` + rotHist (ref:
    ORBmatcher.cc:1746-1780, used by every Search* with mbCheckOrientation).

    angle_a/angle_b: [N] radians for the two matched sets (aligned);
    ok: [N] current acceptance. Returns the filtered mask.
    """
    two_pi = 2.0 * jnp.pi
    diff = (angle_a - angle_b) % two_pi
    bins = jnp.floor(diff / two_pi * n_bins).astype(jnp.int32) % n_bins
    hist = jnp.zeros(n_bins, jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top_vals, top_idx = jax.lax.top_k(hist, keep_top)
    # Reference also drops top-2/3 bins when they are <10% of the max bin
    # (ORBmatcher.cc:1767-1776).
    good_bin = top_vals > (top_vals[0] // 10)
    in_top = jnp.any(
        (bins[:, None] == top_idx[None, :]) & good_bin[None, :], axis=1
    )
    return ok & in_top


def match_masked(
    desc_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    mask: jnp.ndarray,
    max_dist: int,
    ratio: float = 1.0,
    mutual: bool = True,
) -> MatchResult:
    """Generic masked matcher: for each query row, the best allowed target.

    desc_q [Nq, 32], desc_t [Nt, 32], mask [Nq, Nt] True=allowed.
    """
    dmat = D.masked_hamming_matrix(desc_q, desc_t, extra_mask=mask)
    if mutual:
        idx, dist, ok = D.mutual_best(dmat, max_dist, ratio)
    else:
        idx, dist, ok = D.best_match(dmat, max_dist, ratio)
    idx = jnp.where(ok, idx, NO_MATCH)
    return MatchResult(idx, dist, ok)


# ---------------------------------------------------------------------------
# Projection-window searches
# ---------------------------------------------------------------------------

def projection_window_mask(
    uv_proj: jnp.ndarray,
    visible: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_octave: jnp.ndarray,
    feat_valid: jnp.ndarray,
    radius: float,
    scale_factors: jnp.ndarray,
    pred_octave: jnp.ndarray | None = None,
    octave_slack: int = 1,
    octave_slack_up: int | None = None,
) -> jnp.ndarray:
    """[M, N] mask: feature n is a candidate for projected point m.

    Window radius grows with the feature's pyramid level
    (`radius * mvScaleFactors[kp.octave]`, ORBmatcher.cc SearchByProjection)
    and candidates must sit within [-octave_slack, +octave_slack_up] levels
    of the predicted octave (`PredictScale`, MapPoint.cc:~460; the reference
    window [nPredictedLevel-1, nPredictedLevel] is likewise asymmetric).
    """
    if octave_slack_up is None:
        octave_slack_up = octave_slack
    r = radius * scale_factors[feat_octave]  # [N]
    d2 = jnp.sum((uv_proj[:, None, :] - feat_xy[None, :, :]) ** 2, axis=-1)
    mask = d2 <= (r[None, :] ** 2)
    mask &= visible[:, None] & feat_valid[None, :]
    if pred_octave is not None:
        d_oct = feat_octave[None, :] - pred_octave[:, None]
        mask &= (d_oct >= -octave_slack) & (d_oct <= octave_slack_up)
    return mask


def search_by_projection_points(
    cam: cam_mod.Intrinsics,
    Tcw: jnp.ndarray,
    mp_pos: jnp.ndarray,
    mp_desc: jnp.ndarray,
    mp_valid: jnp.ndarray,
    mp_min_dist: jnp.ndarray,
    mp_max_dist: jnp.ndarray,
    mp_normal: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_octave: jnp.ndarray,
    feat_desc: jnp.ndarray,
    feat_valid: jnp.ndarray,
    scale_factors: jnp.ndarray,
    scale_factor: float,
    radius: float,
    max_dist: int,
    ratio: float,
    view_cos_limit: float = 0.5,
    dist_slack: float = 1.2,
    octave_slack: int = 1,
    octave_slack_up: int | None = None,
):
    """Match map points into a frame by projection — the core of
    `SearchByProjection(Frame&, vector<MapPoint*>&, th)` used by
    TrackLocalMap (ref: ORBmatcher.cc:48h / Tracking.cc:1168-1215).

    `dist_slack` loosens only the frustum DISTANCE gate
    ([min/slack, max*slack], Frame::isInFrustum's 0.8/1.2 band) — the
    octave prediction below must use the raw `mp_max_dist`, or points get
    predicted several levels too coarse and the octave window rejects
    every true match.

    Returns per-FEATURE map-point index [N] (NO_MATCH = none) + distances,
    plus the per-point visibility mask (for the "visible" counters the
    culling policy needs, MapPoint.h IncreaseVisible).
    """
    visible, uv, _, _, dist3d = cam_mod.in_frustum(
        cam, Tcw, mp_pos, mp_min_dist / dist_slack, mp_max_dist * dist_slack,
        mp_normal, view_cos_limit,
    )
    visible &= mp_valid
    # Predicted octave from distance (PredictScale: level = log(maxd/d)/log(s)).
    # The ratio sits EXACTLY on an integer boundary when the point is viewed
    # from its creation distance (ratio = s^octave), and platform-dependent
    # log rounding then flips ceil() by a whole level (accelerator vs CPU gave
    # different match sets) — bias by a small epsilon so boundaries resolve
    # down deterministically everywhere.
    n_levels = scale_factors.shape[0]
    ratio_d = jnp.maximum(mp_max_dist, 1e-6) / jnp.maximum(dist3d, 1e-6)
    pred_octave = jnp.clip(
        jnp.ceil(jnp.log(ratio_d) / jnp.log(scale_factor) - 1e-3).astype(jnp.int32),
        0,
        n_levels - 1,
    )
    mask = projection_window_mask(
        uv, visible, feat_xy, feat_octave, feat_valid,
        radius, scale_factors, pred_octave,
        octave_slack=octave_slack, octave_slack_up=octave_slack_up,
    )
    # Query = features (rows of the transposed matrix): per-feature best MP.
    res = match_masked(feat_desc, mp_desc, mask.T, max_dist, ratio)
    return res, visible


def search_frame_frame(
    cam: cam_mod.Intrinsics,
    Tcw: jnp.ndarray,
    prev_mp_pos: jnp.ndarray,
    prev_mp_ok: jnp.ndarray,
    prev_xy: jnp.ndarray,
    prev_octave: jnp.ndarray,
    prev_desc: jnp.ndarray,
    prev_angle: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_octave: jnp.ndarray,
    feat_desc: jnp.ndarray,
    feat_angle: jnp.ndarray,
    feat_valid: jnp.ndarray,
    scale_factors: jnp.ndarray,
    radius: float,
    max_dist: int,
    check_rotation: bool = True,
):
    """Motion-model tracking: project LAST frame's map points with the
    predicted pose and match against current features —
    `SearchByProjection(Frame&, Frame&, th, bMono)` (ref: ORBmatcher.cc:52h,
    called from TrackWithMotionModel Tracking.cc:905).

    prev_mp_pos [Np, 3] world positions attached to last-frame features,
    prev_mp_ok [Np] which last-frame features carry a point. Returns a
    per-current-feature index into PREV features [N] (NO_MATCH = none).
    """
    p_cam = se3.transform(Tcw, prev_mp_pos)
    uv = cam_mod.project(cam, p_cam)
    visible = prev_mp_ok & (p_cam[..., 2] > 0.0) & cam_mod.in_image(cam, uv)
    # Window by the PREV feature's octave; candidates within +-1 level.
    mask = projection_window_mask(
        uv, visible, feat_xy, feat_octave, feat_valid,
        radius, scale_factors, pred_octave=prev_octave, octave_slack=1,
    )
    res = match_masked(feat_desc, prev_desc, mask.T, max_dist, ratio=0.9)
    ok = res.ok
    if check_rotation:
        matched_prev_angle = prev_angle[jnp.clip(res.idx, 0)]
        ok = rotation_consistency(feat_angle, matched_prev_angle, ok)
    return MatchResult(jnp.where(ok, res.idx, NO_MATCH), res.dist, ok)


def search_for_initialization(
    xy1: jnp.ndarray,
    desc1: jnp.ndarray,
    angle1: jnp.ndarray,
    valid1: jnp.ndarray,
    xy2: jnp.ndarray,
    desc2: jnp.ndarray,
    angle2: jnp.ndarray,
    valid2: jnp.ndarray,
    window: float = 100.0,
    max_dist: int = 50,
    ratio: float = 0.9,
    check_rotation: bool = True,
) -> MatchResult:
    """Area-window matching between two monocular frames for map init —
    `SearchForInitialization` (ref: ORBmatcher.cc h70, Tracking.cc:592).

    Returns per-frame-1-feature index into frame-2 features.
    """
    d2 = jnp.sum((xy1[:, None, :] - xy2[None, :, :]) ** 2, axis=-1)
    mask = (d2 <= window * window) & valid1[:, None] & valid2[None, :]
    res = match_masked(desc1, desc2, mask, max_dist, ratio)
    ok = res.ok
    if check_rotation:
        ok = rotation_consistency(angle1, angle2[jnp.clip(res.idx, 0)], ok)
    return MatchResult(jnp.where(ok, res.idx, NO_MATCH), res.dist, ok)


def epipolar_band_mask(
    F12: jnp.ndarray,
    xy1: jnp.ndarray,
    xy2: jnp.ndarray,
    octave2: jnp.ndarray,
    sigma2_per_level: jnp.ndarray,
    chi2_th: float = 3.84,
) -> jnp.ndarray:
    """[N1, N2] mask: point in image 2 lies near the epipolar line of the
    image-1 point, scale-aware — `CheckDistEpipolarLine` (ref:
    ORBmatcher.cc:1646-1664).
    """
    ones1 = jnp.ones((*xy1.shape[:-1], 1), xy1.dtype)
    p1 = jnp.concatenate([xy1, ones1], axis=-1)  # [N1, 3]
    lines = jnp.matmul(p1, F12.T, precision=_HI)  # [N1, 3] epipolar lines in image 2: l = F12^T? see below
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c  # [N1, N2]
    den2 = a * a + b * b
    dsqr = (num * num) / jnp.maximum(den2, 1e-12)
    return dsqr < chi2_th * sigma2_per_level[octave2][None, :]


def search_for_triangulation(
    desc1: jnp.ndarray,
    xy1: jnp.ndarray,
    valid1: jnp.ndarray,
    has_mp1: jnp.ndarray,
    desc2: jnp.ndarray,
    xy2: jnp.ndarray,
    octave2: jnp.ndarray,
    valid2: jnp.ndarray,
    has_mp2: jnp.ndarray,
    F12: jnp.ndarray,
    sigma2_per_level: jnp.ndarray,
    epi_center2: jnp.ndarray | None = None,
    min_epi_dist: jnp.ndarray | None = None,
    max_dist: int = 50,
) -> MatchResult:
    """Epipolar-constrained matching of UNMATCHED features between two
    keyframes for new-point triangulation — `SearchForTriangulation` (ref:
    ORBmatcher.cc h73, LocalMapping.cc:190 CreateNewMapPoints).

    `epi_center2`/`min_epi_dist`: optionally reject features too close to
    the epipole in image 2 (ORBmatcher.cc:~1100 parallax guard).
    """
    mask = valid1[:, None] & valid2[None, :]
    mask &= (~has_mp1)[:, None] & (~has_mp2)[None, :]
    mask &= epipolar_band_mask(F12, xy1, xy2, octave2, sigma2_per_level)
    if epi_center2 is not None:
        d2 = jnp.sum((xy2 - epi_center2[None, :]) ** 2, axis=-1)
        mask &= (d2 > min_epi_dist**2)[None, :]
    return match_masked(desc1, desc2, mask, max_dist, ratio=1.0, mutual=True)


def search_by_descriptor(
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    max_dist: int,
    ratio: float = 0.75,
    mutual: bool = True,
) -> MatchResult:
    """Unconstrained global descriptor matching.

    The stand-in for `SearchByBoW` (ref: ORBmatcher.cc:294 and h65-66):
    the reference restricts candidates to shared vocabulary nodes purely to
    make CPU matching tractable; on the device the full matrix is cheaper and
    strictly more complete. Used by relocalization, loop closing and
    server-side map fusion (`SearchByBoWInServer`).
    """
    mask = valid_q[:, None] & valid_t[None, :]
    return match_masked(desc_q, desc_t, mask, max_dist, ratio, mutual)


def fundamental_from_poses(
    cam1: cam_mod.Intrinsics, Tcw1: jnp.ndarray, cam2: cam_mod.Intrinsics, Tcw2: jnp.ndarray
) -> jnp.ndarray:
    """F12 such that x2^T F12 x1 = 0 — `ComputeF12` (ref: LocalMapping.cc:660).

    Note argument order: maps image-1 points to epipolar lines in image 2
    via l2 = F12 x1 (the transpose convention used in epipolar_band_mask).
    """
    T12 = se3.compose(Tcw1, se3.inverse(Tcw2))  # cam2 -> cam1
    # Relative pose cam1 <- cam2: x1 ~ R12 x2 + t12. E21 = [t]x R maps x2->line in 1.
    # We need lines in image 2 from points in image 1: use T21.
    T21 = se3.inverse(T12)
    R21 = se3.rotation(T21)
    t21 = se3.translation(T21)
    E21 = jnp.matmul(se3.hat(t21), R21, precision=_HI)  # x2^T E21 x1 = 0 (normalized coords)
    K1inv = jnp.linalg.inv(cam1.K)
    K2inv = jnp.linalg.inv(cam2.K)
    return jnp.matmul(jnp.matmul(K2inv.T, E21, precision=_HI), K1inv,
                      precision=_HI)
