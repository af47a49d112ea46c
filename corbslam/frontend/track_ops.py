"""Jitted tracking programs: motion-model tracking, local-map tracking,
keyframe insertion with new-point spawning.

These are the device halves of the reference's `Tracking` thread (ref:
corbslam_client/src/Tracking.cc): `TrackWithMotionModel` (:886),
`TrackReferenceKeyFrame` (:775), `TrackLocalMap` + `SearchLocalPoints`
(:951, :1168), `CreateNewKeyFrame` (:1083). The host state machine
(tracking.py) sequences them; each is one fixed-shape XLA program over the
map SoA.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import pose_opt
from .frame import FrameData

NO_MP = ms.NO_MP


def _pose_opt_from_matches(cam, T_init, frame: FrameData, mp_pos, match_idx):
    """Run motion-only LM from per-feature map-point matches."""
    has = match_idx >= 0
    X = mp_pos[jnp.clip(match_idx, 0)]
    obs = jnp.stack([frame.xy[:, 0], frame.xy[:, 1], frame.uright], axis=-1)
    is_stereo = frame.uright > 0
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * frame.octave.astype(jnp.float32)))
    res = pose_opt.optimize_pose(
        cam, T_init, X, obs, inv_sigma2, is_stereo, has & frame.fvalid
    )
    kept = jnp.where(res.inliers, match_idx, NO_MP)
    return res.Tcw, kept, res.n_inliers


@partial(jax.jit, static_argnames=("cam",))
def track_motion_model(
    cam: cam_mod.Intrinsics,
    mp_pos: jnp.ndarray,        # [M, 3] current map-point positions
    prev: FrameData,
    cur: FrameData,
    T_pred: jnp.ndarray,        # velocity-predicted pose
    scale_factors: jnp.ndarray,
    radius: float = 15.0,
):
    """TrackWithMotionModel: project last frame's points at the predicted
    pose, match, pose-optimize. Returns (Tcw, mp_idx [F], n_inliers)."""
    prev_has = prev.mp_idx >= 0
    prev_pos = mp_pos[jnp.clip(prev.mp_idx, 0)]
    res = matcher.search_frame_frame(
        cam, T_pred,
        prev_pos, prev_has & prev.fvalid,
        prev.xy, prev.octave, prev.desc, prev.angle,
        cur.xy, cur.octave, cur.desc, cur.angle, cur.fvalid,
        scale_factors, radius=radius, max_dist=100,
    )
    # map matched prev-feature -> its map point
    match_mp = jnp.where(res.idx >= 0, prev.mp_idx[jnp.clip(res.idx, 0)], NO_MP)
    return _pose_opt_from_matches(cam, T_pred, cur, mp_pos, match_mp)


@partial(jax.jit, static_argnames=("cam",))
def track_reference_kf(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    ref_kf,
    cur: FrameData,
    T_init: jnp.ndarray,
):
    """TrackReferenceKeyFrame: global descriptor match against one keyframe
    (the reference uses SearchByBoW; dense Hamming subsumes it)."""
    kf_desc = m.kf.desc[ref_kf]
    kf_valid = m.kf.fvalid[ref_kf] & (m.kf.mp_idx[ref_kf] >= 0)
    res = matcher.search_by_descriptor(
        cur.desc, cur.fvalid, kf_desc, kf_valid, max_dist=50, ratio=0.7
    )
    match_mp = jnp.where(
        res.idx >= 0, m.kf.mp_idx[ref_kf][jnp.clip(res.idx, 0)], NO_MP
    )
    return _pose_opt_from_matches(cam, T_init, cur, m.mp.pos, match_mp)


class LocalTrackResult(NamedTuple):
    Tcw: jnp.ndarray
    mp_idx: jnp.ndarray
    n_inliers: jnp.ndarray
    ref_kf: jnp.ndarray
    local_kf_rows: jnp.ndarray
    local_kf_ok: jnp.ndarray
    visible_rows: jnp.ndarray   # [L] compacted local map rows
    visible_mask: jnp.ndarray   # [L] which were frustum-visible
    found_rows_mask: jnp.ndarray  # [L] which got matched


@partial(jax.jit, static_argnames=("cam", "cfg"))
def track_local_map(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    cur: FrameData,
    T_init: jnp.ndarray,
    mp_idx_in: jnp.ndarray,
    cfg: SlamConfig,
):
    """TrackLocalMap: pick local keyframes by shared observations with the
    current matches, project their map points, widen matches, re-optimize.

    (ref: Tracking.cc:951 TrackLocalMap, :1259 UpdateLocalKeyFrames, :1230
    UpdateLocalPoints, :1168 SearchLocalPoints)
    """
    scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
    K1 = cfg.capacity.local_window_kfs
    L = cfg.capacity.local_window_mps

    # 1. Keyframes sharing map points with the current frame.
    cur_mask = jnp.zeros(m.mp.capacity, bool)
    has = mp_idx_in >= 0
    cur_mask = cur_mask.at[jnp.where(has, mp_idx_in, 0)].max(has)
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    share = jnp.where(contrib, cur_mask[jnp.clip(idx, 0)], False)
    kf_weight = jnp.sum(share, axis=1).astype(jnp.int32)  # [N]
    ref_kf = jnp.argmax(kf_weight)
    local_vals, local_rows = jax.lax.top_k(kf_weight, K1)
    local_ok = local_vals > 0

    # 2. Local map points (observed by local KFs), excluding current matches.
    # Frustum-filter BEFORE compaction so the fixed-size local buffer holds
    # only points the camera can currently see (SearchLocalPoints does the
    # same isInFrustum gate before matching, Tracking.cc:1189-1200).
    pmask = covis.local_map_mask(m, local_rows, local_ok)
    pmask &= ~cur_mask
    vis_all, _, _, _, _ = cam_mod.in_frustum(
        cam, T_init, m.mp.pos,
        m.mp.min_dist * 0.5, m.mp.max_dist * 2.0, m.mp.normal,
        view_cos_limit=-1.0,
    )
    pmask &= vis_all
    rows, rows_ok = covis.compact_indices(pmask, L)

    # 3. Project + match the compacted local points.
    res, visible = matcher.search_by_projection_points(
        cam, T_init,
        m.mp.pos[rows], m.mp.desc[rows], rows_ok,
        m.mp.min_dist[rows], m.mp.max_dist[rows], m.mp.normal[rows],
        cur.xy, cur.octave, cur.desc, cur.fvalid & ~has,
        scales, cfg.orb.scale_factor,
        radius=cfg.matcher.search_radius_motion / 4.0,
        max_dist=cfg.matcher.th_high,
        ratio=0.8,
        # No octave gate here: the dense matcher computes the full distance
        # matrix anyway (the reference gates octaves to cut CPU candidates,
        # ORBmatcher.cc SearchByProjection), and the radius window + mutual
        # best + ratio test disambiguate. Measured on the planar E2E sweep:
        # gate off 0.025 ATE vs 0.062-0.090 for every gated window.
        octave_slack=16, octave_slack_up=16,
    )
    new_mp = jnp.where(res.idx >= 0, rows[jnp.clip(res.idx, 0)], NO_MP)
    merged = jnp.where(has, mp_idx_in, new_mp)

    # 4. Final pose optimization over merged matches.
    Tcw, kept, n_inliers = _pose_opt_from_matches(cam, T_init, cur, m.mp.pos, merged)

    found_mask = jnp.zeros(m.mp.capacity, bool)
    kh = kept >= 0
    found_mask = found_mask.at[jnp.where(kh, kept, 0)].max(kh)
    return LocalTrackResult(
        Tcw, kept, n_inliers, ref_kf, local_rows, local_ok,
        rows, visible & rows_ok, found_mask[rows],
    )


# ---------------------------------------------------------------------------
# Fused per-frame tracking program.
#
# Every dispatch and every host sync costs a round trip, so the whole
# OK-state frame — ORB front end, motion-model track (with reference-KF fallback),
# local-map track, tracking-stat scatter, keyframe-policy counters — runs
# as ONE XLA program returning one small summary vector; the host syncs
# exactly once per frame. This is the answer to the reference's
# tracking-thread latency budget (Tracking.cc:266 Track()).
# ---------------------------------------------------------------------------

N_CANDIDATES = 128  # candidate keyframes scored for the local window


class FusedTrackResult(NamedTuple):
    map: ms.MapState
    cur: FrameData
    velocity: jnp.ndarray       # [4,4] T_cur_prev (next frame's prediction)
    local_rows: jnp.ndarray     # [K1] local-window keyframe rows
    local_ok: jnp.ndarray       # [K1]
    ref_kf: jnp.ndarray         # [] i32 new reference keyframe (device copy,
                                #    so the next dispatch needn't wait on the
                                #    summary sync — the pipelined driver)
    summary: jnp.ndarray        # [24] f32, see _summarize


def _summarize(n_track, used_ref, n_local, ref_kf, n_close_tracked,
               n_close_spawn, ok, Tcw):
    head = jnp.stack([
        n_track.astype(jnp.float32), used_ref.astype(jnp.float32),
        n_local.astype(jnp.float32), ref_kf.astype(jnp.float32),
        n_close_tracked.astype(jnp.float32), n_close_spawn.astype(jnp.float32),
        ok.astype(jnp.float32), jnp.float32(0.0),
    ])
    return jnp.concatenate([head, Tcw.reshape(-1)])


def _candidate_local_kfs(m: ms.MapState, mp_idx, prev_local_rows,
                         prev_local_ok, ref_kf, K1: int):
    """Local-keyframe selection over a bounded candidate set.

    The reference walks each tracked point's observation list to collect
    observing keyframes (UpdateLocalKeyFrames, Tracking.cc:1259). Scanning
    the whole [N_kf, F] observation table per frame costs a 4M-element
    gather; instead the candidate set is (a) the anchor keyframes of
    the currently tracked points — which pull OLD keyframes back in after
    relocalization or loop closure — (b) last frame's local window, and
    (c) the most recent keyframes. Exact shared-observation weights are
    then computed only for those ~128 rows.
    """
    N = m.kf.capacity
    F = mp_idx.shape[0]
    has = mp_idx >= 0

    # Tracked-point mask over the landmark table.
    cur_mask = jnp.zeros(m.mp.capacity, bool)
    cur_mask = cur_mask.at[jnp.where(has, mp_idx, 0)].max(has)

    # (a) anchor keyframes of tracked points, weighted by hit count.
    anchors = m.mp.ref_kf[jnp.clip(mp_idx, 0)]
    anchor_count = jnp.zeros(N, jnp.int32).at[
        jnp.where(has & (anchors >= 0), anchors, N)
    ].add(1, mode="drop")
    n_anchor = min(N_CANDIDATES - K1 - 2, N)
    n_recent = min(K1, N)
    a_vals, a_rows = jax.lax.top_k(anchor_count, n_anchor)
    a_ok = a_vals > 0
    # (c) most recent keyframes.
    r_rows = jnp.clip(m.n_kf - 1 - jnp.arange(n_recent, dtype=jnp.int32), 0)
    r_ok = (m.n_kf - 1 - jnp.arange(n_recent, dtype=jnp.int32)) >= 0
    cand = jnp.concatenate([
        a_rows.astype(jnp.int32), prev_local_rows.astype(jnp.int32),
        r_rows, jnp.stack([ref_kf.astype(jnp.int32), jnp.int32(0)]),
    ])
    cand_ok = jnp.concatenate([
        a_ok, prev_local_ok, r_ok, jnp.array([True, True]),
    ])

    # Exact shared-point weights for the candidates only.
    cidx = m.kf.mp_idx[cand]                                   # [C, F]
    contrib = (cidx >= 0) & m.kf.fvalid[cand] & m.kf.valid[cand][:, None]
    contrib &= cand_ok[:, None]
    share = jnp.where(contrib, cur_mask[jnp.clip(cidx, 0)], False)
    w = jnp.sum(share, axis=1).astype(jnp.int32)               # [C]

    # Zero duplicate candidate rows (keep the first VALID occurrence).
    w = covis.dedupe_candidate_weights(cand, w, cand_ok)
    w = jnp.where(cand_ok, w, 0)

    ref_new = cand[jnp.argmax(w)]
    vals, li = jax.lax.top_k(w, K1)
    return cand[li], vals > 0, ref_new, cur_mask


def _local_map_track(cam, m, cur, T_init, mp_idx_in, prev_local_rows,
                     prev_local_ok, ref_kf, cfg: SlamConfig):
    """TrackLocalMap body over the bounded candidate window (the fused
    counterpart of `track_local_map`; ref Tracking.cc:951)."""
    scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
    K1 = cfg.capacity.local_window_kfs
    L = cfg.capacity.local_window_mps

    local_rows, local_ok, ref_new, cur_mask = _candidate_local_kfs(
        m, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf, K1
    )

    pmask = covis.local_map_mask(m, local_rows, local_ok)
    pmask &= ~cur_mask
    vis_all, _, _, _, _ = cam_mod.in_frustum(
        cam, T_init, m.mp.pos,
        m.mp.min_dist * 0.5, m.mp.max_dist * 2.0, m.mp.normal,
        view_cos_limit=-1.0,
    )
    pmask &= vis_all
    rows, rows_ok = covis.compact_indices(pmask, L)

    has = mp_idx_in >= 0
    res, visible = matcher.search_by_projection_points(
        cam, T_init,
        m.mp.pos[rows], m.mp.desc[rows], rows_ok,
        m.mp.min_dist[rows], m.mp.max_dist[rows], m.mp.normal[rows],
        cur.xy, cur.octave, cur.desc, cur.fvalid & ~has,
        scales, cfg.orb.scale_factor,
        radius=cfg.matcher.search_radius_motion / 4.0,
        max_dist=cfg.matcher.th_high,
        ratio=0.8,
        # See track_local_map: no octave gate — the dense matcher's radius
        # window + mutual best + ratio test disambiguate.
        octave_slack=16, octave_slack_up=16,
    )
    new_mp = jnp.where(res.idx >= 0, rows[jnp.clip(res.idx, 0)], NO_MP)
    merged = jnp.where(has, mp_idx_in, new_mp)
    Tcw, kept, n_inliers = _pose_opt_from_matches(cam, T_init, cur, m.mp.pos, merged)

    found_mask = jnp.zeros(m.mp.capacity, bool)
    kh = kept >= 0
    found_mask = found_mask.at[jnp.where(kh, kept, 0)].max(kh)
    return LocalTrackResult(
        Tcw, kept, n_inliers, ref_new, local_rows, local_ok,
        rows, visible & rows_ok, found_mask[rows],
    )


def _track_core(cam, m, cur, prev, velocity, ref_kf, prev_local_rows,
                prev_local_ok, cfg: SlamConfig):
    """Shared body of the fused per-frame programs (cur already built)."""
    scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
    T_pred = se3.compose(velocity, prev.Tcw)

    # 1. Motion-model track; fall back to the reference keyframe when thin
    # (TrackWithMotionModel -> TrackReferenceKeyFrame, Tracking.cc:886/775).
    prev_has = prev.mp_idx >= 0
    prev_pos = m.mp.pos[jnp.clip(prev.mp_idx, 0)]
    mres = matcher.search_frame_frame(
        cam, T_pred,
        prev_pos, prev_has & prev.fvalid,
        prev.xy, prev.octave, prev.desc, prev.angle,
        cur.xy, cur.octave, cur.desc, cur.angle, cur.fvalid,
        scales, radius=cfg.matcher.search_radius_motion, max_dist=100,
    )
    match_mp = jnp.where(mres.idx >= 0, prev.mp_idx[jnp.clip(mres.idx, 0)], NO_MP)
    Tcw1, mp1, n1 = _pose_opt_from_matches(cam, T_pred, cur, m.mp.pos, match_mp)

    def _ref_fallback(_):
        kf_desc = m.kf.desc[ref_kf]
        kf_valid = m.kf.fvalid[ref_kf] & (m.kf.mp_idx[ref_kf] >= 0)
        rres = matcher.search_by_descriptor(
            cur.desc, cur.fvalid, kf_desc, kf_valid, max_dist=50, ratio=0.7
        )
        mm = jnp.where(
            rres.idx >= 0, m.kf.mp_idx[ref_kf][jnp.clip(rres.idx, 0)], NO_MP
        )
        return _pose_opt_from_matches(cam, prev.Tcw, cur, m.mp.pos, mm)

    used_ref = n1 < cfg.tracking.min_inliers_motion
    Tcw0, mp0, n_track = jax.lax.cond(
        used_ref, _ref_fallback, lambda _: (Tcw1, mp1, n1), None
    )

    # 2. Local-map track over the candidate window.
    res = _local_map_track(
        cam, m, cur, Tcw0, mp0, prev_local_rows, prev_local_ok, ref_kf, cfg
    )
    track_ok = n_track >= cfg.tracking.min_inliers_motion
    ok = track_ok & (res.n_inliers >= cfg.tracking.min_tracked_points // 2)

    # 3. Visible/found counters (only for frames that weren't lost before
    # the local-map step, matching the sequential host path).
    nv = m.mp.n_visible.at[res.visible_rows].add(
        (res.visible_mask & track_ok).astype(jnp.int32))
    nf = m.mp.n_found.at[res.visible_rows].add(
        (res.found_rows_mask & track_ok).astype(jnp.int32))
    m = m._replace(mp=m.mp._replace(n_visible=nv, n_found=nf))

    # 4. Keyframe-policy counters (NeedNewKeyFrame, Tracking.cc:1036-1044).
    close = (cur.depth > 0.01) & (
        cur.depth < cfg.tracking.th_depth * cam.baseline
    ) & cur.fvalid
    n_close_tracked = jnp.sum(close & (res.mp_idx >= 0))
    n_close_spawn = jnp.sum(close & (res.mp_idx < 0))

    cur = cur._replace(Tcw=res.Tcw, mp_idx=res.mp_idx)
    vel_next = jnp.where(
        ok, se3.compose(cur.Tcw, se3.inverse(prev.Tcw)), velocity
    )
    summary = _summarize(
        n_track, used_ref, res.n_inliers, res.ref_kf,
        n_close_tracked, n_close_spawn, ok, res.Tcw,
    )
    return FusedTrackResult(m, cur, vel_next, res.local_kf_rows,
                            res.local_kf_ok, res.ref_kf.astype(jnp.int32),
                            summary)


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(0,))
def track_frame_stereo(
    m: ms.MapState,
    prev: FrameData,
    velocity: jnp.ndarray,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    ref_kf: jnp.ndarray,
    prev_local_rows: jnp.ndarray,
    prev_local_ok: jnp.ndarray,
    cam: cam_mod.Intrinsics,
    cfg: SlamConfig,
) -> FusedTrackResult:
    """ONE program: stereo frame build + full OK-state tracking step."""
    from . import frame as frame_mod

    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb)
    return _track_core(cam, m, cur, prev, velocity, ref_kf,
                       prev_local_rows, prev_local_ok, cfg)


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(0,))
def track_frame_stereo2(
    m: ms.MapState,
    prev: FrameData,
    velocity: jnp.ndarray,
    img_l0: jnp.ndarray,
    img_r0: jnp.ndarray,
    img_l1: jnp.ndarray,
    img_r1: jnp.ndarray,
    ref_kf: jnp.ndarray,
    prev_local_rows: jnp.ndarray,
    prev_local_ok: jnp.ndarray,
    cam: cam_mod.Intrinsics,
    cfg: SlamConfig,
):
    """TWO consecutive stereo frames in ONE program (frames_per_dispatch=2).

    Halves the per-frame dispatch count, for hosts where each submission
    costs a noticeable slice of the frame budget. Tracking is sequential by
    nature (frame 1 linearizes around frame 0's result), so the two
    steps chain inside the program exactly as they would across
    dispatches; keyframe policy still runs per frame at retire time."""
    from . import frame as frame_mod

    cur0 = frame_mod.build_frame_stereo(img_l0, img_r0, cam, cfg.orb)
    o0 = _track_core(cam, m, cur0, prev, velocity, ref_kf,
                     prev_local_rows, prev_local_ok, cfg)
    cur1 = frame_mod.build_frame_stereo(img_l1, img_r1, cam, cfg.orb)
    o1 = _track_core(cam, o0.map, cur1, o0.cur, o0.velocity, o0.ref_kf,
                     o0.local_rows, o0.local_ok, cfg)
    return o0, o1


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(0,))
def track_frame_rgbd(
    m: ms.MapState,
    prev: FrameData,
    velocity: jnp.ndarray,
    img: jnp.ndarray,
    depth_map: jnp.ndarray,
    ref_kf: jnp.ndarray,
    prev_local_rows: jnp.ndarray,
    prev_local_ok: jnp.ndarray,
    cam: cam_mod.Intrinsics,
    cfg: SlamConfig,
) -> FusedTrackResult:
    from . import frame as frame_mod

    cur = frame_mod.build_frame_rgbd(img, depth_map, cam, cfg.orb)
    return _track_core(cam, m, cur, prev, velocity, ref_kf,
                       prev_local_rows, prev_local_ok, cfg)


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(0,))
def track_frame_mono(
    m: ms.MapState,
    prev: FrameData,
    velocity: jnp.ndarray,
    img: jnp.ndarray,
    ref_kf: jnp.ndarray,
    prev_local_rows: jnp.ndarray,
    prev_local_ok: jnp.ndarray,
    cam: cam_mod.Intrinsics,
    cfg: SlamConfig,
) -> FusedTrackResult:
    from . import frame as frame_mod

    cur = frame_mod.build_frame_mono(img, cam, cfg.orb)
    return _track_core(cam, m, cur, prev, velocity, ref_kf,
                       prev_local_rows, prev_local_ok, cfg)


@partial(jax.jit, static_argnames=("cam", "cfg", "client"), donate_argnums=(1,))
def insert_keyframe_with_points(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    cur: FrameData,
    frame_id,
    timestamp,
    cfg: SlamConfig,
    client: int = 0,
):
    """CreateNewKeyFrame (ref: Tracking.cc:1083): insert the frame as a
    keyframe and spawn map points for close stereo features without a match
    (Tracking.cc:1113-1155: depth < ThDepth, sorted, at least 100).
    Returns (map, kf_row)."""
    close = (cur.depth > 0.01) & (cur.depth < cfg.tracking.th_depth * cam.baseline)
    spawn = close & cur.fvalid & (cur.mp_idx < 0)
    p_cam = cam_mod.backproject(cam, cur.xy, cur.depth)
    Twc = se3.inverse(cur.Tcw)
    pos_w = se3.transform(Twc, p_cam)
    cam_center = se3.translation(Twc)
    d = pos_w - cam_center
    dist = jnp.linalg.norm(d, axis=-1)
    normal = d / jnp.maximum(dist[:, None], 1e-9)
    level_scale = jnp.asarray(cfg.orb.scales(), jnp.float32)[cur.octave]
    max_dist = dist * level_scale
    min_dist = max_dist / (cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))

    kf_row = m.n_kf
    m2, rows = ms.add_map_points(
        m, pos_w, cur.desc, normal, min_dist, max_dist,
        ref_kf=kf_row, create=spawn, client=client,
    )
    mp_idx = jnp.where(spawn, rows, cur.mp_idx)
    m3, kf_row = ms.insert_keyframe(
        m2, cur.Tcw, cur.xy, cur.octave, cur.angle, cur.desc,
        cur.uright, cur.depth, cur.fvalid, mp_idx,
        frame_id, timestamp, client=client,
    )
    return m3, kf_row, mp_idx


@partial(jax.jit, donate_argnums=(0,))
def update_tracking_stats(
    m: ms.MapState,
    visible_rows: jnp.ndarray,
    visible_mask: jnp.ndarray,
    found_rows_mask: jnp.ndarray,
):
    """IncreaseVisible / IncreaseFound counters driving point culling
    (ref: MapPoint.cc:~300, Tracking.cc:1168-1226)."""
    nv = m.mp.n_visible.at[visible_rows].add(visible_mask.astype(jnp.int32))
    nf = m.mp.n_found.at[visible_rows].add(found_rows_mask.astype(jnp.int32))
    return m._replace(mp=m.mp._replace(n_visible=nv, n_found=nf))
