"""Device programs for the collaboration layer: batched map insertion,
alignment transforms, inter-map overlap detection.

The compute half of the reference's collaboration stack —
`MapFusion::insert*/update*` handlers (ref: corbslam_server/src/
MapFusion.cpp:31-306), `insertServerMapToGlobleMap` :622 (transform every
keyframe pose and landmark into the global frame), and
`detectKeyFrameInServerMap` :660 (BoW candidates -> SearchByBoWInServer ->
EPnP RANSAC). Re-design: entities arrive as fixed-size CHUNKS of flat
arrays (the wire format is already SoA), inserted by one scatter program
per chunk; alignment is one vectorized Sim3 application over the whole
map; overlap detection is the same dense BoW + batched-RANSAC machinery
as intra-map loop closing (loop/loop_closing.py), pointed across maps.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3, sim3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..solvers import pnp as pnp_mod
from ..solvers import sim3_solver

_HI = jax.lax.Precision.HIGHEST

# Wire chunk capacities (the reference streams 50 KFs / 2000 MPs per tick,
# MapFusion.cpp:403-407; powers of two tile better).
KF_CHUNK = 64
MP_CHUNK = 4096


# ---------------------------------------------------------------------------
# Batched insertion (fixed-size chunks)
# ---------------------------------------------------------------------------

@jax.jit
def insert_mp_chunk(
    m: ms.MapState,
    pos: jnp.ndarray,       # [C, 3]
    normal: jnp.ndarray,    # [C, 3]
    desc: jnp.ndarray,      # [C, 32] u8
    min_dist: jnp.ndarray,  # [C]
    max_dist: jnp.ndarray,  # [C]
    client: jnp.ndarray,    # [C] i32
    ref_kf: jnp.ndarray,    # [C] i32 dst keyframe row (or 0)
    use: jnp.ndarray,       # [C] bool
    fixed: jnp.ndarray,     # [C] bool
):
    """Append a chunk of map points at the cursor. Returns (map, rows [C])
    with rows = -1 for unused slots."""
    C = pos.shape[0]
    offs = jnp.cumsum(use.astype(jnp.int32)) - 1
    rows = jnp.where(use, m.n_mp + offs, -1)
    safe = jnp.where(use, rows, m.mp.capacity - 1)

    def put(arr, vals):
        cur = arr[safe]
        sel = use.reshape((C,) + (1,) * (vals.ndim - 1))
        return arr.at[safe].set(jnp.where(sel, vals, cur))

    mp = m.mp
    mp = mp._replace(
        pos=put(mp.pos, pos),
        valid=put(mp.valid, jnp.ones(C, bool)),
        fixed=put(mp.fixed, fixed),
        client=put(mp.client, client),
        desc=put(mp.desc, desc),
        normal=put(mp.normal, normal),
        min_dist=put(mp.min_dist, min_dist),
        max_dist=put(mp.max_dist, max_dist),
        ref_kf=put(mp.ref_kf, ref_kf),
        first_kf=put(mp.first_kf, ref_kf),
        n_visible=put(mp.n_visible, jnp.ones(C, jnp.int32)),
        n_found=put(mp.n_found, jnp.ones(C, jnp.int32)),
    )
    return m._replace(mp=mp, n_mp=m.n_mp + jnp.sum(use.astype(jnp.int32))), rows


@jax.jit
def insert_kf_chunk(
    m: ms.MapState,
    Tcw: jnp.ndarray,        # [C, 4, 4]
    xy: jnp.ndarray,         # [C, F, 2]
    octave: jnp.ndarray,     # [C, F]
    angle: jnp.ndarray,      # [C, F]
    desc: jnp.ndarray,       # [C, F, 32]
    uright: jnp.ndarray,     # [C, F]
    depth: jnp.ndarray,      # [C, F]
    fvalid: jnp.ndarray,     # [C, F]
    mp_idx: jnp.ndarray,     # [C, F] dst map-point rows (already resolved)
    client: jnp.ndarray,     # [C]
    frame_id: jnp.ndarray,   # [C]
    timestamp: jnp.ndarray,  # [C]
    use: jnp.ndarray,        # [C]
    fixed: jnp.ndarray,      # [C]
):
    """Append a chunk of keyframes at the cursor. Returns (map, rows [C])."""
    C = Tcw.shape[0]
    offs = jnp.cumsum(use.astype(jnp.int32)) - 1
    rows = jnp.where(use, m.n_kf + offs, -1)
    safe = jnp.where(use, rows, m.kf.capacity - 1)

    def put(arr, vals):
        cur = arr[safe]
        sel = use.reshape((C,) + (1,) * (vals.ndim - 1))
        return arr.at[safe].set(jnp.where(sel, vals, cur))

    kf = m.kf
    kf = kf._replace(
        Tcw=put(kf.Tcw, Tcw),
        valid=put(kf.valid, jnp.ones(C, bool)),
        fixed=put(kf.fixed, fixed),
        client=put(kf.client, client),
        frame_id=put(kf.frame_id, frame_id),
        timestamp=put(kf.timestamp, timestamp),
        xy=put(kf.xy, xy),
        octave=put(kf.octave, octave),
        angle=put(kf.angle, angle),
        desc=put(kf.desc, desc),
        uright=put(kf.uright, uright),
        depth=put(kf.depth, depth),
        fvalid=put(kf.fvalid, fvalid),
        mp_idx=put(kf.mp_idx, mp_idx),
    )
    return m._replace(kf=kf, n_kf=m.n_kf + jnp.sum(use.astype(jnp.int32))), rows


# ---------------------------------------------------------------------------
# Alignment transforms
# ---------------------------------------------------------------------------

def transform_poses(Tcw: jnp.ndarray, S):
    """Re-express world->cam poses after moving the WORLD by Sim3 S
    (p' = S(p)): Tcw' = Tcw ∘ S^-1, scale folded into translation.
    The server applies exactly this when inserting a sub-map into the
    global frame (MapFusion.cpp:633 `Tcw * To2n`)."""
    # With S^-1 = (Rs, ts, ss), a global point maps back as
    # p_sub = ss*Rs*p_g + ts, so cam = R p_sub + t = ss*R*Rs*p_g + R*ts + t.
    # Fold the scale into the translation (projection is homogeneous):
    # R' = R Rs, t' = (R ts + t)/ss.
    Rs, ts, ss = sim3.inverse(S)
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    R2 = jnp.matmul(R, jnp.broadcast_to(Rs, R.shape), precision=_HI)
    t2 = (jnp.einsum("...ij,j->...i", R, ts, precision=_HI) + t) / jnp.maximum(ss, 1e-12)
    out = jnp.broadcast_to(jnp.eye(4, dtype=Tcw.dtype), Tcw.shape)
    out = out.at[..., :3, :3].set(R2).at[..., :3, 3].set(t2)
    return out


@jax.jit
def transform_map(m: ms.MapState, R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray):
    """Apply alignment Sim3 S=(R,t,s) (sub-world -> dst-world) to a whole
    map: landmark positions p' = S(p), normals rotated, distance bands
    scaled, keyframe poses re-expressed (`insertServerMapToGlobleMap`,
    MapFusion.cpp:622-655 — one vectorized program instead of per-object
    loops)."""
    S = (R, t, s)
    pos = sim3.transform(S, m.mp.pos)
    normal = jnp.einsum("ij,mj->mi", R, m.mp.normal, precision=_HI)
    mp = m.mp._replace(
        pos=jnp.where(m.mp.valid[:, None], pos, m.mp.pos),
        normal=jnp.where(m.mp.valid[:, None], normal, m.mp.normal),
        min_dist=jnp.where(m.mp.valid, m.mp.min_dist * s, m.mp.min_dist),
        max_dist=jnp.where(m.mp.valid, m.mp.max_dist * s, m.mp.max_dist),
    )
    Tcw2 = transform_poses(m.kf.Tcw, S)
    kf = m.kf._replace(
        Tcw=jnp.where(m.kf.valid[:, None, None], Tcw2, m.kf.Tcw)
    )
    return m._replace(kf=kf, mp=mp)


# ---------------------------------------------------------------------------
# Inter-map overlap detection (detectKeyFrameInServerMap)
# ---------------------------------------------------------------------------

class OverlapResult(NamedTuple):
    R: jnp.ndarray          # Sim3 sub-world -> global-world
    t: jnp.ndarray
    s: jnp.ndarray
    n_matches: jnp.ndarray  # descriptor matches
    n_inliers: jnp.ndarray  # PnP inliers
    ok: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "cfg", "fix_scale"))
def detect_overlap(
    cam: cam_mod.Intrinsics,
    gmap: ms.MapState,
    cand_row,                 # candidate keyframe row in the GLOBAL map
    sub: ms.MapState,
    query_row,                # querying keyframe row in the SUB map
    key: jnp.ndarray,
    cfg: SlamConfig,
    fix_scale: bool = True,
) -> OverlapResult:
    """Align a sub-map to the global map through one (query, candidate)
    keyframe pair — `detectKeyFrameInServerMap` (MapFusion.cpp:660):
    SearchByBoWInServer-equivalent dense descriptor matching between the
    query keyframe's features and the candidate's LOCAL map points, EPnP
    RANSAC for the query's pose in the global frame, then a closed-form
    Horn (Sim3) refit over the inlier landmark pairs to get the full
    sub->global alignment (the role of GlobalOptimize::ComputeSim3,
    GlobalOptimize.cpp:51)."""
    # Candidate-side local points (candidate + covisible window).
    nb_rows, nb_ok = covis.top_covisible_of(
        gmap, cand_row, cfg.capacity.local_window_kfs, self_weight=2 ** 30)
    pmask = covis.local_map_mask(gmap, nb_rows, nb_ok)
    rows, rows_ok = covis.compact_indices(pmask, gmap.kf.n_features * 2)

    # Dense match: query features <-> global landmark descriptors.
    res = matcher.search_by_descriptor(
        sub.kf.desc[query_row], sub.kf.fvalid[query_row],
        gmap.mp.desc[rows], rows_ok,
        max_dist=cfg.matcher.th_low, ratio=0.75,
    )
    hit = res.idx >= 0
    n_matches = jnp.sum(hit)
    X_glob = gmap.mp.pos[rows[jnp.clip(res.idx, 0)]]          # [F, 3]
    uv = sub.kf.xy[query_row]
    sf2 = cfg.orb.scale_factor ** 2
    sigma2 = sf2 ** sub.kf.octave[query_row].astype(jnp.float32)

    k1, k2 = jax.random.split(key)
    pnp = pnp_mod.solve_pnp_ransac(
        cam, X_glob, uv, hit, sigma2, k1,
        n_hyp=256, min_inliers=cfg.loop.min_sim3_inliers,
    )

    # Alignment from landmark pairs: the query's OWN landmarks (sub frame)
    # against the matched global landmarks — full Sim3 via weighted Horn on
    # the PnP consensus set (world-frame pairs).
    mp_q = sub.kf.mp_idx[query_row]
    pair_ok = pnp.inliers & (mp_q >= 0)
    p_sub = sub.mp.pos[jnp.clip(mp_q, 0)]
    w = pair_ok.astype(jnp.float32)
    R, t, s = sim3_solver.horn_sim3(X_glob, p_sub, fix_scale, w=w)
    n_pairs = jnp.sum(pair_ok)

    # Fallback when too few landmark pairs: SE3 alignment from the PnP pose
    # (S = Twc_global(query) ∘ Tcw_sub(query)).
    T_align = se3.compose(se3.inverse(pnp.Tcw), sub.kf.Tcw[query_row])
    use_horn = n_pairs >= 10
    R = jnp.where(use_horn, R, T_align[:3, :3])
    t = jnp.where(use_horn, t, T_align[:3, 3])
    s = jnp.where(use_horn, s, 1.0)

    ok = (
        pnp.ok
        & (n_matches >= cfg.loop.min_bow_matches)
        & (pnp.n_inliers >= cfg.loop.min_sim3_inliers)
    )
    return OverlapResult(R, t, s, n_matches, pnp.n_inliers, ok)
