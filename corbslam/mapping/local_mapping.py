"""Local mapping: point culling, neighbor triangulation, local BA, keyframe
culling — the device programs of the reference's `LocalMapping` thread
(ref: corbslam_client/src/LocalMapping.cc: MapPointCulling :161,
CreateNewMapPoints :190, SearchInNeighbors :422, local BA :79,
KeyFrameCulling :590).
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
from ..optim import ba_dense

NO_MP = ms.NO_MP


KF_DETACH_WINDOW = 16  # trailing keyframe rows scanned by the bounded passes


@partial(jax.jit, static_argnames=("cfg", "mono"), donate_argnums=(0,))
def cull_map_points(m: ms.MapState, current_kf_row, cfg: SlamConfig,
                    mono: bool = False) -> ms.MapState:
    """MapPointCulling (ref: LocalMapping.cc:161): kill RECENTLY CREATED
    points whose found/visible ratio is poor, or that gathered too few
    observations within 2-4 keyframes of creation.

    Bounded exactly like the reference: LocalMapping.cc iterates only
    `mlpRecentAddedMapPoints`. Allocation is a monotone cursor, so the
    recent points are a trailing row window [n_mp - R, n_mp); their
    observations can only live in recently inserted keyframes, so the
    observation count scans a trailing keyframe window instead of the full
    [N, F] table."""
    F = m.kf.n_features
    M = m.mp.capacity
    R = min(M, 8 * F)
    KW = min(m.kf.capacity, KF_DETACH_WINDOW)

    base = jnp.maximum(m.n_mp - R, 0)
    rows = base + jnp.arange(R, dtype=jnp.int32)
    rok = rows < m.n_mp

    kbase = jnp.clip(m.n_kf - KW, 0, m.kf.capacity - KW)
    idx = jax.lax.dynamic_slice_in_dim(m.kf.mp_idx, kbase, KW, 0)   # [KW, F]
    fv = jax.lax.dynamic_slice_in_dim(m.kf.fvalid, kbase, KW, 0)
    kv = jax.lax.dynamic_slice_in_dim(m.kf.valid, kbase, KW, 0)
    contrib = (idx >= 0) & fv & kv[:, None]
    # Invalid entries must be POSITIVELY out of bounds: JAX wraps negative
    # indices before the OOB check, so -1 would increment row R-1 and
    # idx < base would wrap onto young rows. R is dropped by mode="drop".
    rel = jnp.where(contrib & (idx >= base), idx - base, R).reshape(-1)
    obs = jnp.zeros(R, jnp.int32).at[rel].add(1, mode="drop")

    ratio = m.mp.n_found[rows].astype(jnp.float32) / jnp.maximum(
        m.mp.n_visible[rows].astype(jnp.float32), 1.0
    )
    age = current_kf_row - m.mp.first_kf[rows]  # keyframe rows since creation
    # cnThObs (LocalMapping.cc:166): 2 for monocular, 3 for stereo/RGB-D.
    # Mono landmarks are born with exactly TWO observations (two-view
    # triangulation); demanding 3 inside the age-2..4 window culled most
    # of the young mono map (observed 678 -> 387 pts over one orbit
    # quarter) and spiralled tracking LOST.
    min_obs = 2 if mono else 3
    bad_ratio = ratio < cfg.mapping.recent_point_min_found_ratio
    young_underobserved = (age >= 2) & (age <= 4) & (obs < min_obs)
    killr = (rok & m.mp.valid[rows] & ~m.mp.fixed[rows]
             & (bad_ratio | young_underobserved))
    kill = jnp.zeros(M, bool).at[rows].set(killr)

    mp = m.mp._replace(valid=m.mp.valid & ~kill)
    # Detach observations within the same trailing keyframe window (older
    # keyframes cannot observe these young points except via rare loop-seam
    # fusion; those stragglers are swept by sweep_detached below).
    is_killed = jnp.where(idx >= 0, kill[jnp.clip(idx, 0)], False)
    new_idx = jnp.where(is_killed, ms.NO_MP, idx)
    kf = m.kf._replace(mp_idx=jax.lax.dynamic_update_slice_in_dim(
        m.kf.mp_idx, new_idx, kbase, 0))
    return m._replace(kf=kf, mp=mp)


@jax.jit
def sweep_detached(m: ms.MapState) -> ms.MapState:
    """Full-map hygiene pass: detach any observation pointing at an invalid
    map point (stragglers the bounded detach windows can miss). One [N, F]
    gather; run episodically, not per keyframe."""
    idx = m.kf.mp_idx
    stale = jnp.where(idx >= 0, ~m.mp.valid[jnp.clip(idx, 0)], False)
    return m._replace(kf=m.kf._replace(mp_idx=jnp.where(stale, ms.NO_MP, idx)))


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(1,))
def fuse_into_kf(
    cam: cam_mod.Intrinsics, m: ms.MapState, kf_row, cfg: SlamConfig
) -> ms.MapState:
    """Duplicate-landmark fusion — `SearchInNeighbors` + `ORBmatcher::Fuse`
    (ref: LocalMapping.cc:422, ORBmatcher.cc Fuse h81-84).

    Projects the map points of covisible neighbor keyframes into the new
    keyframe; a projected point that lands on a feature already bound to a
    DIFFERENT map point reveals a duplicate pair, merged by relabeling every
    observation of the newer point to the older one (the reference's
    MapPoint::Replace, MapPoint.cc:~250). A hit on an unbound feature adds
    an observation. Without this, every keyframe re-spawns landmarks the
    matcher failed to associate and the ratio test then rejects both twins —
    tracking decays monotonically.
    """
    # Candidate points: seen by covisible neighbors, not already bound to
    # this keyframe.
    nb_rows, nb_ok = covis.top_covisible_of(
        m, kf_row, cfg.capacity.local_window_kfs)
    pmask = covis.local_map_mask(m, nb_rows, nb_ok)
    pmask &= ~covis.point_mask_of_kf(m, kf_row)
    rows, rows_ok = covis.compact_indices(pmask, m.kf.n_features * 2)
    return fuse_rows_into_kf(cam, m, kf_row, rows, rows_ok, cfg)


def fuse_rows_into_kf(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    kf_row,
    rows: jnp.ndarray,
    rows_ok: jnp.ndarray,
    cfg: SlamConfig,
    radius: float = 3.0,
    full_relabel: bool = False,
) -> ms.MapState:
    """Core of `ORBmatcher::Fuse` for a given candidate point set: project
    `rows` into keyframe `kf_row`, bind hits on unbound features, merge
    duplicate landmark pairs (MapPoint::Replace semantics). Shared by the
    local-mapping neighbor fuse above and loop closing's `SearchAndFuse`
    (ref: LoopClosing.cc:594, GlobalOptimize.cpp:406)."""
    from ..matching import matcher

    scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
    Tcw = m.kf.Tcw[kf_row]
    res, _ = matcher.search_by_projection_points(
        cam, Tcw,
        m.mp.pos[rows], m.mp.desc[rows], rows_ok,
        m.mp.min_dist[rows], m.mp.max_dist[rows], m.mp.normal[rows],
        m.kf.xy[kf_row], m.kf.octave[kf_row], m.kf.desc[kf_row], m.kf.fvalid[kf_row],
        scales, cfg.orb.scale_factor,
        radius=radius, max_dist=cfg.matcher.th_low, ratio=1.0,
        view_cos_limit=-1.0,
    )
    # Per-feature: projected point row (or -1).
    hit = jnp.where(res.idx >= 0, rows[jnp.clip(res.idx, 0)], NO_MP)
    cur = m.kf.mp_idx[kf_row]

    # Case 1: feature unbound -> bind to the projected point.
    new_idx = jnp.where((cur == NO_MP) & (hit >= 0), hit, cur)

    # Case 2: feature bound to a different point -> duplicate pair.
    dup = (cur >= 0) & (hit >= 0) & (cur != hit)
    older = jnp.minimum(cur, hit)
    newer = jnp.maximum(cur, hit)
    # Relabel map: id -> replacement (one merge step per call).
    relabel = jnp.arange(m.mp.capacity, dtype=jnp.int32)
    relabel = relabel.at[jnp.where(dup, newer, 0)].set(
        jnp.where(dup, older, relabel[0])
    )
    # Kill the newer twins, fold their found/visible counters into the
    # survivor (MapPoint::Replace keeps the statistics).
    kill = jnp.zeros(m.mp.capacity, bool).at[jnp.where(dup, newer, 0)].max(dup)
    add_vis = jax.ops.segment_sum(
        jnp.where(dup, m.mp.n_visible[jnp.clip(newer, 0)], 0), jnp.where(dup, older, 0),
        m.mp.capacity,
    )
    add_fnd = jax.ops.segment_sum(
        jnp.where(dup, m.mp.n_found[jnp.clip(newer, 0)], 0), jnp.where(dup, older, 0),
        m.mp.capacity,
    )
    mp = m.mp._replace(
        valid=m.mp.valid & ~kill,
        n_visible=m.mp.n_visible + add_vis,
        n_found=m.mp.n_found + add_fnd,
    )
    # Apply relabel + detach killed twins. The newer twin of every duplicate
    # pair is a recently spawned point, so its observations live in the
    # trailing keyframe window — relabel there instead of gathering the full
    # [N, F] table (~4M-element gather at default capacities); any straggler
    # reference (rare: loop-seam fusion into old keyframes) is cleaned by
    # sweep_detached's episodic pass and masked by mp.valid meanwhile.
    all_idx = m.kf.mp_idx.at[kf_row].set(new_idx)
    if full_relabel:
        # Loop-seam fusion (SearchAndFuse) merges points observed across the
        # whole map — relabel the full table.
        relabeled = jnp.where(all_idx >= 0, relabel[jnp.clip(all_idx, 0)], NO_MP)
    else:
        KW = min(m.kf.capacity, KF_DETACH_WINDOW)
        kbase = jnp.clip(
            jnp.minimum(m.n_kf - KW, kf_row), 0, m.kf.capacity - KW)
        win = jax.lax.dynamic_slice_in_dim(all_idx, kbase, KW, 0)
        win_new = jnp.where(win >= 0, relabel[jnp.clip(win, 0)], NO_MP)
        relabeled = jax.lax.dynamic_update_slice_in_dim(
            all_idx, win_new, kbase, 0)
    return m._replace(kf=m.kf._replace(mp_idx=relabeled), mp=mp)


class LocalBAInputs(NamedTuple):
    kf_rows: jnp.ndarray   # [W] window keyframe rows
    kf_free: jnp.ndarray   # [W] optimized (True) vs fixed frontier (False)
    kf_ok: jnp.ndarray     # [W] slot used
    mp_rows: jnp.ndarray   # [P] local point rows
    mp_ok: jnp.ndarray     # [P]


def select_local_ba_window(
    m: ms.MapState, kf_row, window: int, frontier: int
) -> LocalBAInputs:
    """Window = current KF + top covisible; frontier = other observers of
    the local points, held fixed (ref: Optimizer.cc:491-545 lLocalKeyFrames
    / lFixedCameras)."""
    win_rows, win_ok = covis.top_covisible_of(
        m, kf_row, window, self_weight=2 ** 30)  # current KF always first

    pmask = covis.local_map_mask(m, win_rows, win_ok)
    mp_rows, mp_ok = covis.compact_indices(pmask, m.kf.n_features * 4)

    # Frontier: keyframes observing local points but outside the window.
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    sees_local = jnp.where(contrib, pmask[jnp.clip(idx, 0)], False)
    n_sees = jnp.sum(sees_local, axis=1).astype(jnp.int32)
    in_window = jnp.zeros(m.kf.capacity, bool).at[win_rows].max(win_ok)
    frontier_w = jnp.where(in_window, 0, n_sees)
    fr_vals, fr_rows = jax.lax.top_k(frontier_w, frontier)
    fr_ok = fr_vals > 0

    kf_rows = jnp.concatenate([win_rows, fr_rows])
    kf_free = jnp.concatenate(
        [jnp.ones(window, bool), jnp.zeros(frontier, bool)]
    )
    kf_ok = jnp.concatenate([win_ok, fr_ok])
    # Keyframes marked fixed (foreign/server) are never optimized
    # (ref: Optimizer.cc:1051 skips getFixed() KFs on writeback).
    kf_free &= ~m.kf.fixed[kf_rows]
    # Gauge: if the window contains row 0 (first KF), it stays fixed; and if
    # nothing at all is fixed (early map, no frontier) pin the oldest window
    # KF (the reference's "fix lowest-id KF" fallback).
    kf_free &= kf_rows != 0
    any_fixed = jnp.any((~kf_free) & kf_ok)
    oldest = jnp.argmin(jnp.where(kf_ok, kf_rows, jnp.int32(2**30)))
    kf_free = jnp.where(
        any_fixed, kf_free, kf_free & (jnp.arange(kf_rows.shape[0]) != oldest)
    )
    return LocalBAInputs(kf_rows, kf_free, kf_ok, mp_rows, mp_ok)


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(1,))
def local_ba(
    cam: cam_mod.Intrinsics, m: ms.MapState, kf_row, cfg: SlamConfig
):
    """LocalBundleAdjustment (ref: Optimizer.cc:487): covisible window +
    fixed frontier, robust then plain LM, writeback + outlier detachment."""
    sel = select_local_ba_window(
        m, kf_row, cfg.mapping.local_ba_window, cfg.mapping.local_ba_window // 2
    )
    prob = ba_dense.problem_from_window(m, sel, cfg.orb.scale_factor)
    res = ba_dense.optimize(
        cam, prob,
        n_iters=cfg.mapping.local_ba_iters,
        cg_iters=cfg.mapping.local_ba_cg_iters,
        huber_iters=3,
    )

    # Write back poses + points.
    wrote_T = jnp.where(
        (sel.kf_free & sel.kf_ok)[:, None, None], res.Tcw, m.kf.Tcw[sel.kf_rows]
    )
    kf = m.kf._replace(Tcw=m.kf.Tcw.at[sel.kf_rows].set(wrote_T))
    wrote_X = jnp.where(
        (sel.mp_ok & ~m.mp.fixed[sel.mp_rows])[:, None], res.X, m.mp.pos[sel.mp_rows]
    )
    mp = m.mp._replace(pos=m.mp.pos.at[sel.mp_rows].set(wrote_X))
    m = m._replace(kf=kf, mp=mp)

    # Detach outlier observations (ref: Optimizer.cc:776-806 erases edges).
    # The dense window layout is [W, F] (camera slot = window slot, feature
    # slot = feature column), so the inlier mask maps back directly.
    out2d = (~res.inlier) & prob.obs_active       # [W, F]
    cur_idx = m.kf.mp_idx[sel.kf_rows]
    new_idx = jnp.where(out2d, NO_MP, cur_idx)
    m = m._replace(kf=m.kf._replace(mp_idx=m.kf.mp_idx.at[sel.kf_rows].set(new_idx)))
    return m


# -- Split local BA (amortized two-stage form) ------------------------------
#
# The fused `local_ba` program costs the whole LM loop on ONE frame — the
# dominant stage-frame latency spike. The split
# form runs the robust phase in one stage and the plain polish + writeback
# in the next, so no single frame pays more than ~half; correctness is
# unaffected because between the two stages only a tracking frame runs,
# which never moves keyframe poses, landmark positions, or keyframe
# observation tables (the quantities the writeback touches).

@partial(jax.jit, static_argnames=("cfg",))
def local_ba_build(m: ms.MapState, kf_row, cfg: SlamConfig):
    """Window selection + problem build as one program (no donation: the
    map lives on)."""
    sel = select_local_ba_window(
        m, kf_row, cfg.mapping.local_ba_window, cfg.mapping.local_ba_window // 2
    )
    prob = ba_dense.problem_from_window(m, sel, cfg.orb.scale_factor)
    return sel, prob


@jax.jit
def local_ba_writeback(
    m: ms.MapState, kf_rows, kf_free, kf_ok, mp_rows, mp_ok,
    Tcw_opt, X_opt, inlier, obs_active,
) -> ms.MapState:
    """Fold an optimized window back into the map (poses, points, outlier
    detachment) — the tail of `local_ba` as its own program."""
    wrote_T = jnp.where(
        (kf_free & kf_ok)[:, None, None], Tcw_opt, m.kf.Tcw[kf_rows]
    )
    kf = m.kf._replace(Tcw=m.kf.Tcw.at[kf_rows].set(wrote_T))
    wrote_X = jnp.where(
        (mp_ok & ~m.mp.fixed[mp_rows])[:, None], X_opt, m.mp.pos[mp_rows]
    )
    mp = m.mp._replace(pos=m.mp.pos.at[mp_rows].set(wrote_X))
    m = m._replace(kf=kf, mp=mp)
    out2d = (~inlier) & obs_active
    cur_idx = m.kf.mp_idx[kf_rows]
    new_idx = jnp.where(out2d, NO_MP, cur_idx)
    return m._replace(
        kf=m.kf._replace(mp_idx=m.kf.mp_idx.at[kf_rows].set(new_idx)))


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def refresh_point_geometry(m: ms.MapState, kf_row, cfg: SlamConfig) -> ms.MapState:
    """Recompute normals + representative descriptors for the points the
    current keyframe's covisible window observes — the bounded equivalent of
    per-point `MapPoint::UpdateNormalAndDepth` / ComputeDistinctiveDescriptors
    (ref: MapPoint.cc:~320,~400), which the reference runs only for points
    TOUCHED by a new keyframe, never map-wide. This windowed pass is a
    [W, F] scan instead of a whole-map segment mean."""
    M = m.mp.capacity
    F = m.kf.n_features
    wins, wok = covis.top_covisible_of(
        m, kf_row, cfg.capacity.local_window_kfs, self_weight=2 ** 30)

    cam_centers = -jnp.einsum(
        "nji,nj->ni", m.kf.Tcw[wins, :3, :3], m.kf.Tcw[wins, :3, 3],
        precision=jax.lax.Precision.HIGHEST,
    )  # [W, 3] camera centers (Ow = -R^T t)
    idx = m.kf.mp_idx[wins]                                 # [W, F]
    contrib = (idx >= 0) & m.kf.fvalid[wins] & m.kf.valid[wins][:, None]
    contrib &= wok[:, None]
    flat_idx = jnp.where(contrib, idx, 0).reshape(-1)
    w = contrib.reshape(-1).astype(jnp.float32)

    pos_per_obs = m.mp.pos[flat_idx]                        # [W*F, 3]
    ctr_per_obs = jnp.repeat(cam_centers, F, axis=0)
    d = pos_per_obs - ctr_per_obs
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    normal_sum = jax.ops.segment_sum(d * w[:, None], flat_idx, M)
    counts = jax.ops.segment_sum(w, flat_idx, M)
    normal = normal_sum / jnp.maximum(counts, 1.0)[:, None]
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)
    has_obs = counts > 0

    # Representative descriptor from the NEWEST window observation — the
    # cheap stand-in for the Hamming medoid; keyframe rows are allocated in
    # time order, so the key ranks by recency.
    key = jnp.where(
        contrib,
        wins[:, None] * F + jnp.arange(F, dtype=jnp.int32)[None, :],
        -1,
    ).reshape(-1)
    newest = jax.ops.segment_max(key, flat_idx, M)
    newest = jnp.where(has_obs, jnp.maximum(newest, 0), 0)
    new_desc = m.kf.desc.reshape(-1, 32)[newest]
    mp = m.mp._replace(
        normal=jnp.where(has_obs[:, None], normal, m.mp.normal),
        desc=jnp.where(has_obs[:, None], new_desc, m.mp.desc),
    )
    return m._replace(mp=mp)


@partial(jax.jit, static_argnames=("cfg", "window"))
def find_redundant_keyframes(
    m: ms.MapState, kf_row, cfg: SlamConfig, window: int = 8
) -> jnp.ndarray:
    """KeyFrameCulling (ref: LocalMapping.cc:590): a local keyframe is
    redundant when >= 90% of its landmarks are observed by at least 3 OTHER
    keyframes at the same or finer scale (scaleLevel + 1 rule,
    LocalMapping.cc:613). Candidates are the covisible neighbors of the
    current keyframe (the reference walks exactly those). Returns a [N]
    kill mask — row 0 (gauge), the current keyframe, and fixed/foreign
    keyframes are never culled.

    One pass builds a per-landmark OCTAVE HISTOGRAM (cumulative over
    levels), then each candidate's redundancy check is pure gathers —
    replacing the per-candidate full-table segment-sum (8 x 4.2M scatter
    elements) with one 4.2M scatter + tiny gathers.
    """
    N, F, M = m.kf.capacity, m.kf.n_features, m.mp.capacity
    L = cfg.orb.n_levels
    cand_rows, cand_ok = covis.top_covisible_of(m, kf_row, window)

    idx_all = m.kf.mp_idx
    contrib_all = (idx_all >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    oct_c = jnp.clip(m.kf.octave, 0, L - 1)
    bucket = jnp.where(
        contrib_all, idx_all * L + oct_c, M * L
    ).reshape(-1)
    hist = jnp.zeros(M * L + 1, jnp.int32).at[bucket].add(1, mode="drop")
    cum = jnp.cumsum(hist[: M * L].reshape(M, L), axis=1)  # [M, L]

    def redundancy(c, ok):
        idx_c = m.kf.mp_idx[c]
        bound = (idx_c >= 0) & m.kf.fvalid[c]
        thr = jnp.clip(m.kf.octave[c] + 1, 0, L - 1)
        # Observations anywhere at octave <= thr, minus this keyframe's own
        # (its octave <= octave+1 always, so it is inside the cumulative).
        n_others = cum[jnp.clip(idx_c, 0), thr] - 1
        red = bound & (n_others >= 3)
        n_bound = jnp.sum(bound)
        ratio = jnp.sum(red) / jnp.maximum(n_bound, 1)
        return ok & (n_bound > 10) & (ratio > cfg.mapping.kf_cull_redundancy)

    kill_c = jax.vmap(redundancy)(cand_rows, cand_ok)
    kill = jnp.zeros(N, bool).at[cand_rows].max(kill_c)
    kill &= m.kf.valid & ~m.kf.fixed
    kill = kill.at[0].set(False).at[kf_row].set(False)
    return kill


def cull_keyframes(m: ms.MapState, kf_row, cfg: SlamConfig):
    """Apply the redundancy rule; returns (map, kill mask) so callers can
    also drop the rows from their BoW database."""
    kill = find_redundant_keyframes(m, kf_row, cfg)
    return ms.cull_keyframes(m, kill), kill
