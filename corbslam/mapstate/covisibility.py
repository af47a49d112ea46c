"""Covisibility graph, derived on device from the observation table.

Replaces the reference's incrementally-maintained covisibility structures
(`KeyFrame::UpdateConnections`, `GetBestCovisibilityKeyFrames`,
`GetVectorCovisibleKeyFrames` — ref: corbslam_client/src/KeyFrame.cc:266-377
plus the spanning-tree bookkeeping): here covisibility weights are always
RECOMPUTED from `kf.mp_idx` with segment reductions / binary matmuls, so
they can never drift out of sync with the observations (a reference failure
mode guarded by mutexes).

Two granularities:
  - `covis_weights_single(m, q)`: [N] weights against one keyframe — the
    per-frame tracking / local-mapping query (O(N*F) gathers).
  - `obs_matrix` + `covis_matrix`: the full [N, N] graph as one int8
    matmul B B^T over the [N, M] observation incidence — used by the
    episodic loop-closing / pose-graph programs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .mapstate import MapState


def point_mask_of_kf(m: MapState, q) -> jnp.ndarray:
    """[M] bool: map points observed by keyframe row q."""
    idx = m.kf.mp_idx[q]
    ok = (idx >= 0) & m.kf.fvalid[q]
    mask = jnp.zeros(m.mp.capacity, bool)
    return mask.at[jnp.where(ok, idx, 0)].max(ok)


def covis_weights_single(m: MapState, q) -> jnp.ndarray:
    """[N] number of map points shared with keyframe q (self included)."""
    pmask = point_mask_of_kf(m, q)
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    shared = jnp.where(contrib, pmask[jnp.clip(idx, 0)], False)
    return jnp.sum(shared, axis=1).astype(jnp.int32)


@jax.jit
def covis_weights_matrix_rows(m: MapState, rows: jnp.ndarray) -> jnp.ndarray:
    """[K, N] covisibility weights of the given keyframe rows against all
    keyframes (vmapped covis_weights_single — used by loop closing's
    consistency groups, LoopClosing.cc:150-231)."""
    return jax.vmap(lambda q: covis_weights_single(m, q))(rows)


def obs_matrix(m: MapState, dtype=jnp.int8) -> jnp.ndarray:
    """[N, M] binary incidence: keyframe n observes point p."""
    N, M = m.kf.capacity, m.mp.capacity
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    B = jnp.zeros((N, M), dtype)
    rows = jnp.broadcast_to(jnp.arange(N)[:, None], idx.shape)
    return B.at[rows.reshape(-1), jnp.where(contrib, idx, 0).reshape(-1)].max(
        contrib.reshape(-1).astype(dtype)
    )


def covis_matrix(m: MapState) -> jnp.ndarray:
    """[N, N] covisibility weights (shared-point counts); diagonal = own
    point counts. One int8 matmul."""
    B = obs_matrix(m)
    W = jax.lax.dot_general(
        B, B, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )
    return W


# ---------------------------------------------------------------------------
# Candidate-windowed covisibility — the per-keyframe hot path.
#
# covis_weights_single costs a [N, F] gather at the default capacities and
# runs several times per keyframe in
# the mapping pipeline. The bounded form below computes EXACT shared-point
# weights, but only against a ~160-row candidate set: the anchor keyframes
# of q's own landmarks (mp.ref_kf — which reach arbitrarily OLD keyframes
# after loop closures, since old points keep old anchors) plus the most
# recent keyframes. The reference walks per-point observation lists
# (KeyFrame::UpdateConnections, KeyFrame.cc:266) — anchors + recency is the
# fixed-shape stand-in for that observer walk.
# ---------------------------------------------------------------------------

def anchor_candidates(m: MapState, mp_rows: jnp.ndarray, ok: jnp.ndarray,
                      n_anchor: int, n_recent: int, extra_rows=()):
    """Bounded keyframe-candidate set for covisibility against a landmark
    set: top anchor keyframes of the given map-point rows (by hit count) +
    the `n_recent` newest keyframes + any extras. Returns (cand, cand_ok)."""
    N = m.kf.capacity
    n_anchor = min(n_anchor, N)
    n_recent = min(n_recent, N)
    anchors = m.mp.ref_kf[jnp.clip(mp_rows, 0)]
    cnt = jnp.zeros(N, jnp.int32).at[
        jnp.where(ok & (anchors >= 0), anchors, N)
    ].add(1, mode="drop")
    a_vals, a_rows = jax.lax.top_k(cnt, n_anchor)
    a_ok = a_vals > 0
    r = jnp.arange(n_recent, dtype=jnp.int32)
    r_rows = jnp.clip(m.n_kf - 1 - r, 0)
    r_ok = (m.n_kf - 1 - r) >= 0
    parts_r = [a_rows.astype(jnp.int32), r_rows]
    parts_o = [a_ok, r_ok]
    for e in extra_rows:
        e = jnp.atleast_1d(jnp.asarray(e, jnp.int32))
        parts_r.append(e)
        parts_o.append(jnp.ones(e.shape, bool))
    return jnp.concatenate(parts_r), jnp.concatenate(parts_o)


def dedupe_candidate_weights(cand: jnp.ndarray, w: jnp.ndarray,
                             ok=None) -> jnp.ndarray:
    """Zero the weight of repeated candidate rows (keep the first VALID
    occurrence — invalid entries, e.g. top-k padding rows, must not shadow
    a later valid duplicate)."""
    C = cand.shape[0]
    eff = cand if ok is None else jnp.where(
        ok, cand, -1 - jnp.arange(C, dtype=cand.dtype))
    eq = eff[:, None] == eff[None, :]
    dup = jnp.any(eq & jnp.tril(jnp.ones((C, C), bool), -1), axis=1)
    return jnp.where(dup, 0, w)


def candidate_covis_weights(m: MapState, q, n_anchor: int = 112,
                            n_recent: int = 47):
    """(cand [C], w [C]) exact shared-point counts between keyframe q and
    the bounded candidate set (C = n_anchor + n_recent + 1; q included)."""
    idxq = m.kf.mp_idx[q]
    okq = (idxq >= 0) & m.kf.fvalid[q]
    cand, cand_ok = anchor_candidates(m, idxq, okq, n_anchor, n_recent, [q])
    pmask = point_mask_of_kf(m, q)
    cidx = m.kf.mp_idx[cand]
    contrib = (cidx >= 0) & m.kf.fvalid[cand] & m.kf.valid[cand][:, None]
    contrib &= cand_ok[:, None]
    share = jnp.where(contrib, pmask[jnp.clip(cidx, 0)], False)
    w = jnp.sum(share, axis=1).astype(jnp.int32)
    return cand, dedupe_candidate_weights(cand, w, cand_ok)


def top_covisible_of(m: MapState, q, k: int, min_weight: int = 1,
                     self_weight: int = 0):
    """Top-k covisible keyframe rows of q over the candidate window —
    the bounded GetBestCovisibilityKeyFrames (KeyFrame.cc:276).

    `self_weight=0` excludes q; a large value (2**30) pins q first.
    Returns (rows [k], ok [k])."""
    cand, w = candidate_covis_weights(m, q)
    w = jnp.where(cand == q, self_weight, w)
    vals, li = jax.lax.top_k(w, min(k, cand.shape[0]))
    rows, ok = cand[li], vals >= max(min_weight, 1)
    if k > cand.shape[0]:  # tiny-capacity configs: pad to the asked size
        pad = k - cand.shape[0]
        rows = jnp.concatenate([rows, jnp.zeros(pad, rows.dtype)])
        ok = jnp.concatenate([ok, jnp.zeros(pad, bool)])
    return rows, ok


@partial(jax.jit, static_argnames=("n_group",))
def covis_groups_rows(m: MapState, rows: jnp.ndarray, n_group: int = 10):
    """[C, n_group] covisible-group keyframe rows for each given row + ok
    mask — the per-candidate accumulation groups of DetectLoopCandidates
    (KeyFrameDatabase.cc:120-160), via the anchor approximation (one
    [C, F] gather instead of C full observation-table scans)."""
    N = m.kf.capacity
    idx = m.kf.mp_idx[rows]                        # [C, F]
    ok = (idx >= 0) & m.kf.fvalid[rows]
    anchors = m.mp.ref_kf[jnp.clip(idx, 0)]        # [C, F]
    C = rows.shape[0]
    cnt = jnp.zeros((C, N), jnp.int32)
    rr = jnp.broadcast_to(jnp.arange(C)[:, None], anchors.shape)
    cnt = cnt.at[rr, jnp.where(ok & (anchors >= 0), anchors, 0)].add(
        (ok & (anchors >= 0)).astype(jnp.int32))
    vals, grp = jax.lax.top_k(cnt, min(n_group, N))
    return grp, vals > 0


def top_covisible(weights: jnp.ndarray, q, k: int, min_weight: int = 15):
    """Top-k covisible keyframe rows of q by weight (excluding q itself).

    Mirrors GetBestCovisibilityKeyFrames / the >=15-shared-points threshold
    (KeyFrame.cc:276). Returns (rows [k], ok [k])."""
    w = weights.at[q].set(0)
    vals, rows = jax.lax.top_k(w, k)
    return rows, vals >= min_weight


def local_map_mask(m: MapState, kf_rows: jnp.ndarray, kf_ok: jnp.ndarray) -> jnp.ndarray:
    """[M] mask of map points observed by any of the given keyframes —
    the tracking local map (UpdateLocalPoints, Tracking.cc:1230)."""
    idx = m.kf.mp_idx[kf_rows]  # [K, F]
    ok = (idx >= 0) & m.kf.fvalid[kf_rows] & kf_ok[:, None]
    mask = jnp.zeros(m.mp.capacity, bool)
    return mask.at[jnp.where(ok, idx, 0)].max(ok) & m.mp.valid


def spanning_parents(m) -> jnp.ndarray:
    """[N] parent row per keyframe: the nearest EARLIER valid row OF THE
    SAME CLIENT — the per-client temporal chain. Keyframe rows are allocated
    sequentially per client, so this is the reference's spanning tree for
    sequential SLAM (KeyFrame's parent is the max-covisibility keyframe at
    creation time, i.e. a recent one of the same robot; KeyFrame.h:140-150).
    In a MERGED multi-client map rows interleave clients, so the chain must
    not cross client seams: a cross-client "nearest earlier row" edge would
    act as a rigid zero-residual odometry constraint between unrelated
    trajectories. Row 0 / per-client-first / orphan rows get parent -1.
    """
    N = m.kf.capacity
    valid = m.kf.valid
    # Group rows by client (invalid rows to the end); within a client the
    # stable sort keeps rows ascending, so a segmented exclusive running
    # max yields the nearest earlier valid same-client row.
    ckey = jnp.where(valid, m.kf.client, jnp.int32(2 ** 30))
    order = jnp.argsort(ckey, stable=True)
    ids_s = jnp.where(valid[order], order, -1)
    c_s = ckey[order]

    def seg_max(a, b):
        ca, va = a
        cb, vb = b
        return cb, jnp.where(ca == cb, jnp.maximum(va, vb), vb)

    _, pmax = jax.lax.associative_scan(seg_max, (c_s, ids_s))
    pm_prev = jnp.concatenate([jnp.asarray([-1], jnp.int32), pmax[:-1]])
    c_prev = jnp.concatenate([jnp.asarray([-1], jnp.int32), c_s[:-1]])
    par_s = jnp.where(c_prev == c_s, pm_prev, -1)
    parent = jnp.zeros(N, jnp.int32).at[order].set(par_s)
    return jnp.where(valid, parent, -1)


def compact_indices(mask: jnp.ndarray, k: int, newest_first: bool = True):
    """Fixed-size compaction: rows of up to k True entries of `mask`.

    Returns (rows [k] i32, ok [k] bool). When the mask has more than k
    entries, `newest_first` keeps the HIGHEST row indices — allocation is a
    monotone cursor, so high rows are the most recently created map points,
    which are the ones the current camera can actually see. (Keeping the
    oldest rows silently filled tracking's local map with stale points as
    the map grew — a capacity-truncation failure mode the reference's
    unbounded std::set maps cannot have, SURVEY.md §5.7.)
    """
    n = mask.shape[0]
    row = jnp.arange(n, dtype=jnp.int32)
    key = mask.astype(jnp.int32) * (n + 1) + (row if newest_first else n - row)
    _, rows = jax.lax.top_k(key, k)
    ok = mask[rows]
    return rows.astype(jnp.int32), ok
