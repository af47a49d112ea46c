"""Loop closing: detection, Sim3 computation, loop correction, essential
graph.

Replaces the reference's `LoopClosing` thread (ref:
corbslam_client/src/LoopClosing.cc: DetectLoop :100 with
covisibility-consistency groups :150-231, ComputeSim3 :233, CorrectLoop
:404 incl. SearchAndFuse :594 and the OptimizeEssentialGraph call; the
server-side clone is GlobalOptimize.cpp ComputeSim3 :51 / CorrectLoop
:228). Re-design:

- detection = one dense BoW score+top-k program (place/database.py) —
  no inverted file;
- Sim3 = batched Horn RANSAC over all hypotheses at once
  (solvers/sim3_solver.py) + weighted closed-form refit on the consensus
  set + a projection widening pass (the reference's
  SearchByProjection-in-ComputeSim3, GlobalOptimize.cpp:199-211);
- essential graph = fixed-capacity Sim3 pose graph (optim/pose_graph.py)
  whose edges (spanning chain + strong covisibility + accumulated loop
  edges) are built by one device program from the covisibility matrix —
  no pointer walks, no nMaxKFid-sized arrays;
- map-point correction = one gather/scatter over anchor keyframes.

Only the consistency-group bookkeeping (a handful of small integer sets
per detection) lives on the host, mirroring the reference's
mvConsistentGroups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3, sim3
from ..mapping import local_mapping
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import pose_graph as pg
from ..place import database as db_mod
from ..place import vocab as vocab_mod
from ..solvers import sim3_solver

_HI = jax.lax.Precision.HIGHEST

# Max loop edges remembered across the run (fixed capacity for the pose
# graph program; the reference accumulates loop edges in KeyFrame::mspLoopEdges).
MAX_LOOP_EDGES = 32
# Strong-covisibility threshold for essential-graph edges (Optimizer.cc:840
# uses minFeat=100).
ESSENTIAL_MIN_WEIGHT = 100


# ---------------------------------------------------------------------------
# Sim3 between two keyframes (ComputeSim3)
# ---------------------------------------------------------------------------

class Sim3Between(NamedTuple):
    R: jnp.ndarray        # candidate-cam -> query-cam rotation
    t: jnp.ndarray
    s: jnp.ndarray
    n_bow: jnp.ndarray    # descriptor matches between bound features
    n_inliers: jnp.ndarray
    n_total: jnp.ndarray  # widened projection matches
    ok: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "cfg", "fix_scale"))
def compute_sim3(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    kf_q,
    kf_c,
    key: jnp.ndarray,
    cfg: SlamConfig,
    fix_scale: bool = True,
) -> Sim3Between:
    """Sim3 candidate->query from landmark correspondences.

    Mirrors LoopClosing::ComputeSim3 (LoopClosing.cc:233) /
    GlobalOptimize::ComputeSim3 (GlobalOptimize.cpp:51): match the map
    points bound to each keyframe's features (SearchByBoW equivalent),
    Horn RANSAC in the two camera frames, refit on inliers, then widen by
    projecting the candidate side's local points into the query keyframe
    and gate on total match count.
    """
    mp_q = m.kf.mp_idx[kf_q]
    mp_c = m.kf.mp_idx[kf_c]
    bound_q = m.kf.fvalid[kf_q] & (mp_q >= 0)
    bound_c = m.kf.fvalid[kf_c] & (mp_c >= 0)
    res = matcher.search_by_descriptor(
        m.kf.desc[kf_q], bound_q, m.kf.desc[kf_c], bound_c,
        max_dist=cfg.matcher.th_low, ratio=0.75,
    )
    pair_ok = res.idx >= 0
    mp_c_matched = mp_c[jnp.clip(res.idx, 0)]
    pair_ok &= mp_c_matched >= 0
    n_bow = jnp.sum(pair_ok)

    pw_q = m.mp.pos[jnp.clip(mp_q, 0)]
    pw_c = m.mp.pos[jnp.clip(mp_c_matched, 0)]
    Tq = m.kf.Tcw[kf_q]
    Tc = m.kf.Tcw[kf_c]
    p1 = se3.transform(Tq, pw_q)   # query-cam coords
    p2 = se3.transform(Tc, pw_c)   # candidate-cam coords
    sf2 = cfg.orb.scale_factor ** 2
    s2_q = sf2 ** m.kf.octave[kf_q].astype(jnp.float32)
    oct_c = m.kf.octave[kf_c][jnp.clip(res.idx, 0)]
    s2_c = sf2 ** oct_c.astype(jnp.float32)

    ransac = sim3_solver.solve_sim3_ransac(
        cam, cam, p1, p2, pair_ok, s2_q, s2_c, key,
        n_hyp=256, min_inliers=cfg.loop.min_sim3_inliers, fix_scale=fix_scale,
    )
    # Iterative robust refinement with inlier re-classification — the role
    # of Optimizer::OptimizeSim3 (Optimizer.cc:1120, gated at
    # GlobalOptimize.cpp:147-151): each round reclassifies EVERY candidate
    # pair against the improving model, so matches the RANSAC consensus
    # missed re-enter and borderline seams tighten.
    R, t, s, ref_inl, n_ref = sim3_solver.refine_sim3_iterative(
        cam, cam, p1, p2, pair_ok, s2_q, s2_c,
        ransac.R, ransac.t, ransac.s, fix_scale=fix_scale, n_rounds=3,
    )
    use = (ransac.n_inliers >= 3) & (n_ref >= 3)
    R = jnp.where(use, R, ransac.R)
    t = jnp.where(use, t, ransac.t)
    s = jnp.where(use, s, ransac.s)
    n_inliers = jnp.where(use, jnp.maximum(n_ref, ransac.n_inliers),
                          ransac.n_inliers)

    # Widen: project the candidate's local map points into the query
    # keyframe with the implied pose Scw_q = S_qc ∘ Scw_c
    # (GlobalOptimize.cpp:199-211 SearchByProjection, accept >= 40 total).
    nb_rows, nb_ok = covis.top_covisible_of(
        m, kf_c, cfg.capacity.local_window_kfs, self_weight=2 ** 30)
    pmask = covis.local_map_mask(m, nb_rows, nb_ok)
    rows, rows_ok = covis.compact_indices(pmask, m.kf.n_features * 2)

    Rq = jnp.matmul(R, Tc[:3, :3], precision=_HI)
    tq = s * jnp.matmul(R, Tc[:3, 3], precision=_HI) + t
    T_pred = jnp.eye(4).at[:3, :3].set(Rq).at[:3, 3].set(tq / jnp.maximum(s, 1e-9))
    scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
    res2, _ = matcher.search_by_projection_points(
        cam, T_pred,
        m.mp.pos[rows], m.mp.desc[rows], rows_ok,
        m.mp.min_dist[rows], m.mp.max_dist[rows], m.mp.normal[rows],
        m.kf.xy[kf_q], m.kf.octave[kf_q], m.kf.desc[kf_q], m.kf.fvalid[kf_q],
        scales, cfg.orb.scale_factor,
        radius=7.5, max_dist=cfg.matcher.th_low, ratio=1.0,
        view_cos_limit=-1.0,
    )
    n_total = jnp.sum(res2.idx >= 0)

    # 2D-3D pose refinement of the correction over the WIDENED matches —
    # the decisive robustness stage (r5). The 3D-3D Sim3 above aligns
    # duplicate landmark clouds whose positions carry stereo depth noise
    # (sigma_z ~ z^2/bf) and which often span a NARROW far patch of the
    # scene: the alignment is then near-degenerate — an 11-degree rotation
    # about a 15 m lever arm traded against 4+ m of translation fit the r4
    # room-world pairs exactly as well as the truth, passed every
    # reprojection gate, and bent the corrected map 10x (post-loop ate_kf
    # 0.70 vs 0.07). Optimizing the QUERY POSE against the candidate
    # side's 3D points through the query's own 2D observations (spread
    # across the image, depth-weighted) pins the correction the way
    # relocalization pins a lost frame — the reference gets the same
    # effect from OptimizeSim3's bidirectional image-space edges on the
    # widened match set (Optimizer.cc:1120; GlobalOptimize.cpp:199-211).
    from ..optim import pose_opt as pose_opt_mod

    obs_q = jnp.concatenate(
        [m.kf.xy[kf_q], m.kf.uright[kf_q][:, None]], axis=-1)
    octv = m.kf.octave[kf_q].astype(jnp.float32)
    inv_s2 = 1.0 / (cfg.orb.scale_factor ** (2.0 * octv))

    def widen_and_opt(T0, radius):
        r, _ = matcher.search_by_projection_points(
            cam, T0,
            m.mp.pos[rows], m.mp.desc[rows], rows_ok,
            m.mp.min_dist[rows], m.mp.max_dist[rows], m.mp.normal[rows],
            m.kf.xy[kf_q], m.kf.octave[kf_q], m.kf.desc[kf_q],
            m.kf.fvalid[kf_q],
            scales, cfg.orb.scale_factor,
            radius=radius, max_dist=cfg.matcher.th_low, ratio=1.0,
            view_cos_limit=-1.0,
        )
        X_m = m.mp.pos[rows][jnp.clip(r.idx, 0)]
        p = pose_opt_mod.optimize_pose(
            cam, T0, X_m, obs_q, inv_s2,
            is_stereo=m.kf.uright[kf_q] > 0, valid=r.idx >= 0,
        )
        pok = jnp.isfinite(p.Tcw).all()
        return jnp.where(pok, p.Tcw, T0), p.n_inliers, pok

    # Round 1 reuses the first widen's matches; rounds 2-3 RE-GATHER the
    # matches around the improving pose — the first widen only sees points
    # consistent with the (possibly several-meters-off) 3D-3D prediction,
    # so a single optimization inherits that selection bias (measured r5:
    # one round left the correction 1.4 m off; re-widening converges).
    X_m = m.mp.pos[rows][jnp.clip(res2.idx, 0)]
    po = pose_opt_mod.optimize_pose(
        cam, T_pred, X_m, obs_q, inv_s2,
        is_stereo=m.kf.uright[kf_q] > 0, valid=res2.idx >= 0,
    )
    T_ref = jnp.where(jnp.isfinite(po.Tcw).all(), po.Tcw, T_pred)
    T_ref, n_po, ok2 = widen_and_opt(T_ref, 7.5)
    T_ref, n_po2, ok3 = widen_and_opt(T_ref, 4.0)
    po_n = jnp.where(ok3, n_po2, jnp.where(ok2, n_po, po.n_inliers))
    po_ok = (
        jnp.isfinite(T_ref).all()
        & (po_n >= cfg.loop.min_total_matches)
    )
    # Fold the refined query pose back into the candidate->query Sim3:
    # p_q = s' R' p_c + t' with R' = R_po Rc^T, t' = s (t_po - R' tc)
    # (projection is invariant to the structure scale, so the pose-opt SE3
    # lives in candidate units and the 3D-3D scale estimate is kept).
    R_rel = jnp.matmul(T_ref[:3, :3], Tc[:3, :3].T, precision=_HI)
    t_rel = s * (T_ref[:3, 3] - jnp.matmul(R_rel, Tc[:3, 3], precision=_HI))
    R = jnp.where(po_ok, R_rel, R)
    t = jnp.where(po_ok, t_rel, t)
    n_total = jnp.where(po_ok, po_n, n_total)

    ok = (
        ransac.ok
        & po_ok
        & (n_inliers >= cfg.loop.min_sim3_inliers)
        & (n_bow >= cfg.loop.min_bow_matches)
        & (n_total >= cfg.loop.min_total_matches)
    )
    return Sim3Between(R, t, s, n_bow, n_inliers, n_total, ok)


# ---------------------------------------------------------------------------
# Essential graph construction + loop correction
# ---------------------------------------------------------------------------

class LoopEdges(NamedTuple):
    """Fixed-capacity record of accepted loop closures (KeyFrame::mspLoopEdges)."""

    i: jnp.ndarray   # [L] candidate kf row
    j: jnp.ndarray   # [L] query kf row
    R: jnp.ndarray   # [L, 3, 3] Sim3 candidate->query at acceptance time
    t: jnp.ndarray   # [L, 3]
    s: jnp.ndarray   # [L]
    valid: jnp.ndarray  # [L]

    @staticmethod
    def empty(capacity: int = MAX_LOOP_EDGES) -> "LoopEdges":
        return LoopEdges(
            i=jnp.zeros(capacity, jnp.int32),
            j=jnp.zeros(capacity, jnp.int32),
            R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (capacity, 1, 1)),
            t=jnp.zeros((capacity, 3), jnp.float32),
            s=jnp.ones(capacity, jnp.float32),
            valid=jnp.zeros(capacity, bool),
        )

    def add(self, n: int, kf_c, kf_q, R, t, s) -> "LoopEdges":
        return LoopEdges(
            i=self.i.at[n].set(kf_c),
            j=self.j.at[n].set(kf_q),
            R=self.R.at[n].set(R),
            t=self.t.at[n].set(t),
            s=self.s.at[n].set(s),
            valid=self.valid.at[n].set(True),
        )


def spanning_parents(m: ms.MapState) -> jnp.ndarray:
    """Per-client temporal spanning chain (see covisibility.spanning_parents;
    kept as a re-export here because the essential graph below and the GBA
    merge-back both consume it). Deriving parents from post-hoc covisibility
    instead would rewire the query's parent to the LOOP keyframe after
    SearchAndFuse merges their landmarks — an odometry edge measuring the
    loop discontinuity."""
    return covis.spanning_parents(m)


def build_essential_graph(
    m: ms.MapState,
    loops: LoopEdges,
    fixed_row,
    meas_Tcw: jnp.ndarray,
    covis_k: int = 8,
    min_weight: int = ESSENTIAL_MIN_WEIGHT,
) -> pg.PoseGraph:
    """Assemble the Sim3 pose graph (OptimizeEssentialGraph's edge set,
    Optimizer.cc:840): spanning chain + top-k strong covisibility + loop
    edges. Edge MEASUREMENTS come from `meas_Tcw` — the PRE-correction pose
    snapshot (the reference's NonCorrectedSim3 map): measurements must
    encode odometry, not the already-corrected state, or the graph starts
    at zero residual and distributes nothing. Loop edges carry their
    accepted Sim3. Vertices are INITIALIZED from the current (corrected)
    map poses."""
    N = m.kf.capacity
    Rm = meas_Tcw[:, :3, :3]
    tm = meas_Tcw[:, :3, 3]
    sm = jnp.ones(N, jnp.float32)

    # --- spanning chain edges (parent -> child) -------------------------
    parent = spanning_parents(m)
    sp_i = jnp.clip(parent, 0)
    sp_j = jnp.arange(N, dtype=jnp.int32)
    sp_ok = (parent >= 0) & m.kf.valid

    # --- strong covisibility edges (upper triangle, top-k per row) ------
    W = covis.covis_matrix(m)
    W = jnp.where(m.kf.valid[:, None] & m.kf.valid[None, :], W, 0)
    upper = jnp.arange(N)[None, :] > jnp.arange(N)[:, None]
    Wu = jnp.where(upper, W, 0)
    cv_vals, cv_j = jax.lax.top_k(Wu, covis_k)           # per-row top-k [N, k]
    cv_i = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, covis_k))
    cv_ok = cv_vals >= min_weight
    # Drop covis duplicates of spanning edges (edge (parent[j], j)).
    cv_ok &= cv_i != sp_i[jnp.clip(cv_j, 0)]

    # A pair already constrained by a LOOP edge must not also get an
    # odometry edge: its pre-correction relative pose measures the loop
    # DISCONTINUITY, which would fight the loop constraint (the reference's
    # sInsertedEdges guard, Optimizer.cc:935-1000). After SearchAndFuse the
    # loop pair is strongly covisible, so both the spanning parent and the
    # covis top-k would otherwise re-add it.
    def is_loop_pair(a, b):
        return jnp.any(
            (loops.valid[None, :])
            & (
                ((a[:, None] == loops.i[None, :]) & (b[:, None] == loops.j[None, :]))
                | ((a[:, None] == loops.j[None, :]) & (b[:, None] == loops.i[None, :]))
            ),
            axis=1,
        )

    sp_ok &= ~is_loop_pair(sp_i, sp_j)
    cv_shape = cv_i.shape
    cv_ok &= ~is_loop_pair(cv_i.reshape(-1), cv_j.reshape(-1)).reshape(cv_shape)

    e_i = jnp.concatenate([sp_i, cv_i.reshape(-1), loops.i])
    e_j = jnp.concatenate([sp_j, cv_j.reshape(-1), loops.j])
    e_ok = jnp.concatenate([sp_ok, cv_ok.reshape(-1), loops.valid])
    e_ok &= e_i != e_j

    # Measurements: S_ji = S_j ∘ S_i^-1 from the snapshot poses (se3, s=1);
    # loop edges use the stored Sim3 (candidate i -> query j).
    Si = (Rm[e_i], tm[e_i], sm[e_i])
    Sj = (Rm[e_j], tm[e_j], sm[e_j])
    mR, mt, msc = jax.vmap(lambda a, b: sim3.compose(b, sim3.inverse(a)))(Si, Sj)
    n_base = N + N * covis_k
    mR = mR.at[n_base:].set(loops.R)
    mt = mt.at[n_base:].set(loops.t)
    msc = msc.at[n_base:].set(loops.s)

    fixed = ~m.kf.valid | m.kf.fixed
    fixed = fixed.at[fixed_row].set(True)
    fixed = fixed.at[0].set(True)  # gauge: first keyframe pinned

    return pg.PoseGraph(
        R=m.kf.Tcw[:, :3, :3], t=m.kf.Tcw[:, :3, 3],
        s=jnp.ones(N, jnp.float32), fixed=fixed,
        e_i=e_i, e_j=e_j, mR=mR, mt=mt, ms=msc,
        e_valid=e_ok, e_weight=jnp.ones(e_i.shape[0], jnp.float32),
    )


@partial(jax.jit, static_argnames=("cfg",))
def correct_window(
    m: ms.MapState,
    kf_q,
    kf_c,
    R_qc: jnp.ndarray,
    t_qc: jnp.ndarray,
    s_qc: jnp.ndarray,
    cfg: SlamConfig,
):
    """First-order loop correction of the query keyframe's covisible window
    (CorrectLoop's CorrectedSim3 propagation, LoopClosing.cc:430-520 /
    GlobalOptimize.cpp:253-338): every window keyframe i gets
    S_iw_corr = (T_i ∘ T_q^-1) ∘ S_qw_corr with S_qw_corr = S_qc ∘ S_cw, and
    every map point anchored in the window moves by S_corr^-1 ∘ S_old.

    Returns (map, window_mask [N]).
    """
    N = m.kf.capacity
    w = covis.covis_weights_single(m, kf_q) * m.kf.valid
    window = (w > 0) & m.kf.valid
    window = window.at[kf_q].set(True)
    window &= ~m.kf.fixed  # foreign/server keyframes are read-only

    Tq = m.kf.Tcw[kf_q]
    Sc = sim3.from_se3(m.kf.Tcw[kf_c])
    Sq_corr = sim3.compose((R_qc, t_qc, s_qc), Sc)

    Twq = se3.inverse(Tq)
    T_iq = jax.vmap(lambda T: se3.compose(T, Twq))(m.kf.Tcw)  # [N,4,4]
    S_corr = jax.vmap(lambda T: sim3.compose(sim3.from_se3(T), Sq_corr))(T_iq)
    S_old = jax.vmap(sim3.from_se3)(m.kf.Tcw)

    # Map points anchored to window keyframes: p' = S_corr^-1(S_old(p)).
    anchor = jnp.clip(m.mp.ref_kf, 0)
    mp_move = m.mp.valid & ~m.mp.fixed & window[anchor]
    Sa_old = jax.tree.map(lambda x: x[anchor], S_old)
    Sa_corr = jax.tree.map(lambda x: x[anchor], S_corr)
    p_cam = jax.vmap(sim3.transform)(Sa_old, m.mp.pos)
    Sa_inv = jax.vmap(sim3.inverse)(Sa_corr)
    p_new = jax.vmap(sim3.transform)(Sa_inv, p_cam)
    mp = m.mp._replace(pos=jnp.where(mp_move[:, None], p_new, m.mp.pos))

    # Window poses: fold scale into translation (eigt /= s, LoopClosing.cc:500).
    Rc, tc, sc = S_corr
    T_new = (
        jnp.tile(jnp.eye(4, dtype=jnp.float32), (N, 1, 1))
        .at[:, :3, :3].set(Rc)
        .at[:, :3, 3].set(tc / jnp.maximum(sc, 1e-9)[:, None])
    )
    T_new = se3.orthonormalize_fast(T_new)
    kf = m.kf._replace(Tcw=jnp.where(window[:, None, None], T_new, m.kf.Tcw))
    return m._replace(kf=kf, mp=mp), window


@partial(jax.jit, static_argnames=("cfg", "n_iters"))
def optimize_essential_graph(
    m: ms.MapState,
    loops: LoopEdges,
    fixed_row,
    meas_Tcw: jnp.ndarray,
    cfg: SlamConfig,
    n_iters: int = 20,
):
    """Run the Sim3 pose graph over the whole map and write back poses and
    anchor-corrected map points (Optimizer::OptimizeEssentialGraph writeback,
    Optimizer.cc:1032-1110 — skipping server-fixed entities). `meas_Tcw` is
    the pre-correction pose snapshot used for edge measurements; map points
    follow their anchor keyframe's CURRENT -> optimized delta (they were
    already made consistent with the current poses by correct_window)."""
    S_old = (
        m.kf.Tcw[:, :3, :3],
        m.kf.Tcw[:, :3, 3],
        jnp.ones(m.kf.capacity, jnp.float32),
    )
    g = build_essential_graph(m, loops, fixed_row, meas_Tcw)
    (R, t, s), costs = pg.optimize(g, n_iters=n_iters, cg_iters=40)

    writable = m.kf.valid & ~m.kf.fixed
    T_new = (
        jnp.tile(jnp.eye(4, dtype=jnp.float32), (m.kf.capacity, 1, 1))
        .at[:, :3, :3].set(R)
        .at[:, :3, 3].set(t / jnp.maximum(s, 1e-9)[:, None])
    )
    T_new = se3.orthonormalize_fast(T_new)
    kf = m.kf._replace(Tcw=jnp.where(writable[:, None, None], T_new, m.kf.Tcw))

    anchor = jnp.clip(m.mp.ref_kf, 0)
    Sa_old = jax.tree.map(lambda x: x[anchor], S_old)
    Sa_new = (R[anchor], t[anchor], s[anchor])
    p_cam = jax.vmap(sim3.transform)(Sa_old, m.mp.pos)
    p_new = jax.vmap(sim3.transform)(jax.vmap(sim3.inverse)(Sa_new), p_cam)
    mp_move = m.mp.valid & ~m.mp.fixed & writable[anchor]
    mp = m.mp._replace(pos=jnp.where(mp_move[:, None], p_new, m.mp.pos))
    return m._replace(kf=kf, mp=mp), costs


@partial(jax.jit, static_argnames=("cam", "cfg"), donate_argnums=(1,))
def fuse_loop_points(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    kf_q,
    kf_c,
    cfg: SlamConfig,
):
    """SearchAndFuse (LoopClosing.cc:594): project the loop side's local map
    points into the (already corrected) query keyframe and its neighbors,
    merging duplicate landmarks. One fuse pass on the query keyframe — the
    covisible neighbors then inherit merges through the relabeled mp_idx."""
    nb_rows, nb_ok = covis.top_covisible_of(
        m, kf_c, cfg.capacity.local_window_kfs, self_weight=2 ** 30)
    pmask = covis.local_map_mask(m, nb_rows, nb_ok)
    rows, rows_ok = covis.compact_indices(pmask, m.kf.n_features * 2)
    return local_mapping.fuse_rows_into_kf(
        cam, m, kf_q, rows, rows_ok, cfg, radius=4.0, full_relabel=True
    )


# ---------------------------------------------------------------------------
# Host-side loop closer (consistency groups + orchestration)
# ---------------------------------------------------------------------------

@dataclass
class _ConsistentGroup:
    rows: set
    count: int


@dataclass
class LoopCloserStats:
    n_detections: int = 0
    n_sim3_attempts: int = 0
    n_loops_closed: int = 0
    last_loop: Optional[tuple] = None  # (kf_q, kf_c)
    # Rolling log of Sim3 verification attempts for diagnosis:
    # (kf_q, kf_c, n_bow, n_inliers, n_total, ok). Mirrors the counts the
    # reference prints per ComputeSim3 (GlobalOptimize.cpp:147-211).
    sim3_log: list = field(default_factory=list)

    def log_sim3(self, kf_q, kf_c, sb, cap: int = 64):
        self.sim3_log.append((
            int(kf_q), int(kf_c), int(sb.n_bow), int(sb.n_inliers),
            int(sb.n_total), bool(sb.ok),
        ))
        if len(self.sim3_log) > cap:
            del self.sim3_log[: len(self.sim3_log) - cap]


class LoopCloser:
    """Host orchestration of loop closing for one client map.

    The consistency-group state machine mirrors LoopClosing::DetectLoop
    (LoopClosing.cc:150-231): a candidate only fires after its covisibility
    group has been re-detected in `covisibility_consistency_th` consecutive
    keyframes. All scoring/matching/solving runs in the jitted programs
    above; this object only keeps a few small integer sets.
    """

    def __init__(
        self,
        cam: cam_mod.Intrinsics,
        cfg: SlamConfig,
        voc: vocab_mod.Vocabulary,
        fix_scale: bool = True,
        run_gba: bool = True,
        seed: int = 0,
    ):
        self.cam = cam
        self.cfg = cfg
        self.voc = voc
        self.fix_scale = fix_scale
        self.run_gba = run_gba
        self.db = db_mod.BowDatabase.empty(cfg.capacity.max_keyframes, voc.n_words)
        self.loops = LoopEdges.empty()
        self.n_loops = 0
        self.consistent_groups: List[_ConsistentGroup] = []
        self.last_loop_kf = -(10 ** 9)
        self.stats = LoopCloserStats()
        self.gba_runner = None
        # Per-stage finiteness audit of CorrectLoop (host syncs per stage;
        # loop closures are episodic, so the cost is negligible — enable in
        # e2e harnesses to localize numerical blowups).
        self.debug_checks = False
        # Directory to dump CorrectLoop inputs (map snapshot + loop edges)
        # for offline solver debugging; None disables.
        self.dump_dir = None
        self._key = jax.random.PRNGKey(seed)
        if run_gba:
            from . import gba as gba_mod

            self.gba_runner = gba_mod.GlobalBARunner(cam, cfg)

    # -- helpers ---------------------------------------------------------
    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def compute_bow(self, m: ms.MapState, kf_row: int) -> jnp.ndarray:
        return vocab_mod.transform(
            self.voc, m.kf.desc[kf_row], m.kf.fvalid[kf_row]
        )

    # -- main entry -------------------------------------------------------
    def process_keyframe(self, m: ms.MapState, kf_row: int) -> ms.MapState:
        """Add the keyframe to the BoW database, detect + verify + correct.
        Returns the (possibly loop-corrected) map."""
        bow = self.compute_bow(m, kf_row)
        self.db = self.db.add(kf_row, bow)

        # Throttle like the reference: no detection within 10 KFs of the
        # last loop or map start (LoopClosing.cc:111).
        if kf_row < 10 or kf_row - self.last_loop_kf < 10:
            self.consistent_groups = []
            return m

        cand_rows, cand_ok = db_mod.detect_loop_candidates(
            self.db, m, kf_row, bow, k=8,
        )
        cand = [int(r) for r, o in zip(np.asarray(cand_rows), np.asarray(cand_ok)) if o]
        if not cand:
            self.consistent_groups = []
            return m
        self.stats.n_detections += 1

        enough = self._update_consistency(m, cand)
        for kf_c in enough:
            self.stats.n_sim3_attempts += 1
            sb = compute_sim3(
                self.cam, m, kf_row, kf_c, self._next_key(), self.cfg,
                fix_scale=self.fix_scale,
            )
            self.stats.log_sim3(kf_row, kf_c, sb)
            if not bool(sb.ok):
                continue
            m = self.close_loop(m, kf_row, kf_c, sb)
            break
        return m

    def _update_consistency(self, m: ms.MapState, cand: List[int]) -> List[int]:
        """Covisibility-consistency filtering (LoopClosing.cc:150-231).

        Candidate groups come from the bounded anchor window
        (covis.covis_groups_rows) instead of full observation-table scans —
        one [C, F] gather for all candidates."""
        grp, gok = covis.covis_groups_rows(m, jnp.asarray(cand), n_group=24)
        grp_np, gok_np = np.asarray(grp), np.asarray(gok)
        enough: List[int] = []
        new_groups: List[_ConsistentGroup] = []
        for ci, c in enumerate(cand):
            group = set(grp_np[ci][gok_np[ci]].tolist()) | {c}
            consistent = False
            for prev in self.consistent_groups:
                if group & prev.rows:
                    cnt = prev.count + 1
                    new_groups.append(_ConsistentGroup(group, cnt))
                    consistent = True
                    if cnt >= self.cfg.loop.covisibility_consistency_th:
                        enough.append(c)
                    break
            if not consistent:
                new_groups.append(_ConsistentGroup(group, 0))
        self.consistent_groups = new_groups
        return enough

    def close_loop(
        self, m: ms.MapState, kf_q: int, kf_c: int, sb: Sim3Between
    ) -> ms.MapState:
        """CorrectLoop (LoopClosing.cc:404): abort any running GBA, correct
        the window, fuse duplicates, pose-graph the essential graph, then
        kick off a fresh global BA."""
        if self.gba_runner is not None:
            self.gba_runner.abort()

        meas_Tcw = m.kf.Tcw  # pre-correction snapshot (NonCorrectedSim3)
        m, _window = correct_window(m, kf_q, kf_c, sb.R, sb.t, sb.s, self.cfg)
        self._audit(m, "correct_window")
        m = fuse_loop_points(self.cam, m, kf_q, kf_c, self.cfg)

        slot = self.n_loops % MAX_LOOP_EDGES
        self.loops = self.loops.add(slot, kf_c, kf_q, sb.R, sb.t, sb.s)
        self.n_loops += 1

        if getattr(self, "dump_dir", None) is not None:
            import os
            import pickle

            import numpy as np

            snap = jax.tree.map(np.asarray, {
                "m": m, "loops": self.loops, "kf_q": kf_q, "kf_c": kf_c,
                "meas_Tcw": meas_Tcw,
            })
            with open(os.path.join(
                    self.dump_dir, f"loop_{self.n_loops}.pkl"), "wb") as f:
                pickle.dump(snap, f)

        m, _costs = optimize_essential_graph(
            m, self.loops, kf_c, meas_Tcw, self.cfg,
            n_iters=self.cfg.loop.pose_graph_iters,
        )
        self._audit(m, "essential_graph")
        self.last_loop_kf = kf_q
        self.stats.n_loops_closed += 1
        self.stats.last_loop = (kf_q, kf_c)
        self.consistent_groups = []

        if self.gba_runner is not None:
            self.gba_runner.launch(m)
        return m

    def reset(self):
        """System hard reset (Tracking::Reset clears the KeyFrameDatabase
        and loop state, Tracking.cc:1533): empty the BoW database, the
        accumulated loop edges and consistency groups, abort any running
        GBA."""
        self.db = db_mod.BowDatabase.empty(
            self.cfg.capacity.max_keyframes, self.voc.n_words)
        self.loops = LoopEdges.empty()
        self.n_loops = 0
        self.consistent_groups = []
        self.last_loop_kf = -(10 ** 9)
        if self.gba_runner is not None:
            self.gba_runner.abort()

    def remap_rows(self, res):
        """Apply a map compaction (mapstate.compact result): the BoW
        database rows, accumulated loop edges and consistency state are all
        keyframe-row-aligned and must follow the repack."""
        self.db = self.db.reorder(res.kf_order, res.m.n_kf)
        kmap = res.kf_old2new
        li = kmap[jnp.clip(self.loops.i, 0)]
        lj = kmap[jnp.clip(self.loops.j, 0)]
        self.loops = self.loops._replace(
            i=jnp.clip(li, 0), j=jnp.clip(lj, 0),
            valid=self.loops.valid & (li >= 0) & (lj >= 0),
        )
        self.consistent_groups = []
        if self.last_loop_kf >= 0:
            import numpy as np

            nl = int(np.asarray(kmap)[self.last_loop_kf])
            self.last_loop_kf = nl if nl >= 0 else -(10 ** 9)
        if self.gba_runner is not None:
            # A running GBA holds pre-compaction row numbering; discard it.
            self.gba_runner.abort()

    def _audit(self, m: ms.MapState, stage: str):
        # getattr: harnesses may build partially-initialized LoopClosers.
        if not getattr(self, "debug_checks", False):
            return
        import numpy as np

        bad_kf = np.asarray(m.kf.valid) & ~np.isfinite(
            np.asarray(m.kf.Tcw)).all(axis=(1, 2))
        bad_mp = np.asarray(m.mp.valid) & ~np.isfinite(
            np.asarray(m.mp.pos)).all(axis=1)
        if bad_kf.any() or bad_mp.any():
            print(f"[loop-audit] {stage}: {bad_kf.sum()} nonfinite KF poses "
                  f"(rows {np.nonzero(bad_kf)[0][:8].tolist()}...), "
                  f"{bad_mp.sum()} nonfinite MP", flush=True)

    # -- GBA result merge (called by the tracker between frames) ----------
    def try_merge_gba(self, m: ms.MapState) -> ms.MapState:
        if self.gba_runner is None:
            return m
        out = self.gba_runner.try_merge(m)
        if out is not m:
            self._audit(out, "gba_merge")
        return out
