"""Fixed-capacity structure-of-arrays map state.

The device-resident replacement of the reference's pointer-graph map
(ref: corbslam_client/src/KeyFrame.cc, MapPoint.cc, Map.cc, Cache.cc): a
keyframe is a row across the `KeyFrames` arrays, a landmark a row across
`MapPoints`, and every cross-reference is an integer index — the same idea
as the reference's `LightKeyFrame`/`LightMapPoint` id-handles
(LightKeyFrame.h:38-41), which is exactly the batched device representation
(SURVEY.md §2.1: "the single most accelerator-friendly design idea in the
reference").

Growth model (SURVEY.md §5.7): capacities are static; slots carry validity
masks; allocation is a monotone cursor; culling clears masks. Dynamic map
size never reaches XLA — every program sees the same shapes.

Observations are stored once, on the keyframe side: `mp_idx [N, F]` maps
feature f of keyframe n to a map-point row (or -1). Everything the
reference maintains incrementally by hand — per-point observation lists,
covisibility weights, spanning trees, reference descriptors, normals —
is DERIVED from `mp_idx` by segment reductions on device (covisibility.py),
eliminating the reference's mutex-guarded double bookkeeping
(MapPoint::AddObservation + KeyFrame::AddMapPoint + UpdateConnections).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CapacityConfig

NO_MP = -1


class KeyFrames(NamedTuple):
    """SoA over keyframe slots (capacity N, features F per keyframe)."""

    Tcw: jnp.ndarray        # [N, 4, 4] world->camera
    valid: jnp.ndarray      # [N] slot in use
    fixed: jnp.ndarray      # [N] foreign/server data: read-only for local opt
    client: jnp.ndarray     # [N] i32 owning client id
    frame_id: jnp.ndarray   # [N] i32 source frame number
    timestamp: jnp.ndarray  # [N] f32
    # Per-feature arrays (the reference's Frame payload):
    xy: jnp.ndarray         # [N, F, 2] undistorted pixel coords
    octave: jnp.ndarray     # [N, F] i32
    angle: jnp.ndarray      # [N, F] f32
    desc: jnp.ndarray       # [N, F, 32] u8
    uright: jnp.ndarray     # [N, F] f32 (-1 mono)
    depth: jnp.ndarray      # [N, F] f32 (0 unknown)
    fvalid: jnp.ndarray     # [N, F] feature slot in use
    mp_idx: jnp.ndarray     # [N, F] i32 map-point row or NO_MP

    @property
    def capacity(self):
        return self.Tcw.shape[0]

    @property
    def n_features(self):
        return self.xy.shape[1]


class MapPoints(NamedTuple):
    """SoA over landmark slots (capacity M)."""

    pos: jnp.ndarray       # [M, 3] world
    valid: jnp.ndarray     # [M]
    fixed: jnp.ndarray     # [M] foreign/server data
    client: jnp.ndarray    # [M] i32
    desc: jnp.ndarray      # [M, 32] u8 distinctive descriptor
    normal: jnp.ndarray    # [M, 3] mean viewing direction (cam->point)
    min_dist: jnp.ndarray  # [M] scale-invariance band
    max_dist: jnp.ndarray  # [M]
    ref_kf: jnp.ndarray    # [M] i32 creating keyframe row
    first_kf: jnp.ndarray  # [M] i32 (for recent-point culling policy)
    n_visible: jnp.ndarray # [M] i32 tracking statistics (IncreaseVisible)
    n_found: jnp.ndarray   # [M] i32 (IncreaseFound)

    @property
    def capacity(self):
        return self.pos.shape[0]


class MapState(NamedTuple):
    kf: KeyFrames
    mp: MapPoints
    n_kf: jnp.ndarray  # scalar i32 allocation cursor
    n_mp: jnp.ndarray


def empty(cap: CapacityConfig) -> MapState:
    N, F, M = cap.max_keyframes, cap.max_features, cap.max_map_points
    kf = KeyFrames(
        Tcw=jnp.tile(jnp.eye(4, dtype=jnp.float32), (N, 1, 1)),
        valid=jnp.zeros(N, bool),
        fixed=jnp.zeros(N, bool),
        client=jnp.zeros(N, jnp.int32),
        frame_id=jnp.zeros(N, jnp.int32),
        timestamp=jnp.zeros(N, jnp.float32),
        xy=jnp.zeros((N, F, 2), jnp.float32),
        octave=jnp.zeros((N, F), jnp.int32),
        angle=jnp.zeros((N, F), jnp.float32),
        desc=jnp.zeros((N, F, 32), jnp.uint8),
        uright=jnp.full((N, F), -1.0, jnp.float32),
        depth=jnp.zeros((N, F), jnp.float32),
        fvalid=jnp.zeros((N, F), bool),
        mp_idx=jnp.full((N, F), NO_MP, jnp.int32),
    )
    mp = MapPoints(
        pos=jnp.zeros((M, 3), jnp.float32),
        valid=jnp.zeros(M, bool),
        fixed=jnp.zeros(M, bool),
        client=jnp.zeros(M, jnp.int32),
        desc=jnp.zeros((M, 32), jnp.uint8),
        normal=jnp.zeros((M, 3), jnp.float32),
        min_dist=jnp.zeros(M, jnp.float32),
        max_dist=jnp.zeros(M, jnp.float32),
        ref_kf=jnp.zeros(M, jnp.int32),
        first_kf=jnp.zeros(M, jnp.int32),
        n_visible=jnp.ones(M, jnp.int32),
        n_found=jnp.ones(M, jnp.int32),
    )
    return MapState(kf, mp, jnp.int32(0), jnp.int32(0))


# ---------------------------------------------------------------------------
# Functional insert / update
# ---------------------------------------------------------------------------

def insert_keyframe(
    m: MapState,
    Tcw: jnp.ndarray,
    xy: jnp.ndarray,
    octave: jnp.ndarray,
    angle: jnp.ndarray,
    desc: jnp.ndarray,
    uright: jnp.ndarray,
    depth: jnp.ndarray,
    fvalid: jnp.ndarray,
    mp_idx: jnp.ndarray,
    frame_id,
    timestamp,
    client: int = 0,
    fixed: bool = False,
):
    """Insert one keyframe at the allocation cursor. Returns (map, kf_row).

    At capacity the write is DROPPED (kf_row comes back == capacity and the
    cursor stays put) rather than clamped onto the last row — the clamped
    scatter silently overwrote the newest keyframe every frame once a long
    run exhausted max_keyframes. Hosts gate creation beforehand
    (tracking._create_keyframe); this is the device-side backstop."""
    i = m.n_kf
    kf = m.kf
    kf = kf._replace(
        Tcw=kf.Tcw.at[i].set(Tcw, mode="drop"),
        valid=kf.valid.at[i].set(True, mode="drop"),
        fixed=kf.fixed.at[i].set(fixed, mode="drop"),
        client=kf.client.at[i].set(client, mode="drop"),
        frame_id=kf.frame_id.at[i].set(frame_id, mode="drop"),
        timestamp=kf.timestamp.at[i].set(timestamp, mode="drop"),
        xy=kf.xy.at[i].set(xy, mode="drop"),
        octave=kf.octave.at[i].set(octave, mode="drop"),
        angle=kf.angle.at[i].set(angle, mode="drop"),
        desc=kf.desc.at[i].set(desc, mode="drop"),
        uright=kf.uright.at[i].set(uright, mode="drop"),
        depth=kf.depth.at[i].set(depth, mode="drop"),
        fvalid=kf.fvalid.at[i].set(fvalid, mode="drop"),
        mp_idx=kf.mp_idx.at[i].set(mp_idx, mode="drop"),
    )
    return m._replace(kf=kf, n_kf=jnp.minimum(i + 1, m.kf.capacity)), i


def add_map_points(
    m: MapState,
    pos: jnp.ndarray,        # [K, 3]
    desc: jnp.ndarray,       # [K, 32]
    normal: jnp.ndarray,     # [K, 3]
    min_dist: jnp.ndarray,   # [K]
    max_dist: jnp.ndarray,   # [K]
    ref_kf,                  # scalar or [K]
    create: jnp.ndarray,     # [K] bool which rows to actually allocate
    client: int = 0,
    fixed: bool = False,
):
    """Batch-allocate map points at the cursor; masked rows are skipped.

    Returns (map, rows [K] i32) — rows are the allocated indices for created
    entries and NO_MP for skipped ones. Slot allocation is a masked prefix
    sum so the program shape is static regardless of how many points a
    keyframe actually spawns (the reference allocates one object per
    triangulation, LocalMapping.cc:360).
    """
    K = pos.shape[0]
    offs = jnp.cumsum(create.astype(jnp.int32)) - 1  # position among created
    # Capacity guard: allocations past the fixed landmark budget are DROPPED
    # (rows stay NO_MP, nothing is written) instead of clamping the scatter
    # onto the last row — which silently corrupted that landmark and handed
    # out out-of-range bindings once a long run exhausted max_map_points
    # (SURVEY.md §5.7: fixed capacities + culling bound growth; overflow must
    # degrade to "no new points", the reference's behavior when its allocator
    # would fail, not to corruption).
    create = create & (m.n_mp + offs < m.mp.capacity)
    rows = jnp.where(create, m.n_mp + offs, NO_MP)
    n_new = jnp.sum(create.astype(jnp.int32))
    # Masked rows scatter to the POSITIVELY out-of-range bucket `capacity`
    # and are dropped — never routed through a real slot, where a duplicate
    # index with a legitimate allocation would have an unspecified winner
    # (mirrors insert_keyframe's drop-mode scatter).
    scatter_rows = jnp.where(create, rows, m.mp.capacity)

    def put(arr, vals):
        return arr.at[scatter_rows].set(vals, mode="drop")

    mp = m.mp
    ref_arr = jnp.broadcast_to(jnp.asarray(ref_kf, jnp.int32), (K,))
    mp = mp._replace(
        pos=put(mp.pos, pos),
        valid=put(mp.valid, jnp.ones(K, bool)),
        fixed=put(mp.fixed, jnp.full(K, fixed)),
        client=put(mp.client, jnp.full(K, client, jnp.int32)),
        desc=put(mp.desc, desc),
        normal=put(mp.normal, normal),
        min_dist=put(mp.min_dist, min_dist),
        max_dist=put(mp.max_dist, max_dist),
        ref_kf=put(mp.ref_kf, ref_arr),
        first_kf=put(mp.first_kf, ref_arr),
        n_visible=put(mp.n_visible, jnp.ones(K, jnp.int32)),
        n_found=put(mp.n_found, jnp.ones(K, jnp.int32)),
    )
    return m._replace(mp=mp, n_mp=m.n_mp + n_new), rows


def set_kf_matches(m: MapState, kf_row, mp_idx: jnp.ndarray) -> MapState:
    """Overwrite the feature->map-point assignment of one keyframe."""
    return m._replace(kf=m.kf._replace(mp_idx=m.kf.mp_idx.at[kf_row].set(mp_idx)))


def observation_counts(m: MapState) -> jnp.ndarray:
    """[M] number of keyframe observations per map point (derived)."""
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.valid[:, None] & m.kf.fvalid
    flat = jnp.where(contrib, idx, 0).reshape(-1)
    w = contrib.reshape(-1).astype(jnp.int32)
    return jax.ops.segment_sum(w, flat, m.mp.capacity)


def cull_map_points(m: MapState, kill: jnp.ndarray) -> MapState:
    """Invalidate map points and detach their observations.

    `kill` [M] bool. Equivalent of MapPoint::SetBadFlag (MapPoint.cc:~150):
    the reference walks per-point observation lists; here one vectorized
    lookup clears every reference in kf.mp_idx.
    """
    mp = m.mp._replace(valid=m.mp.valid & ~kill)
    idx = m.kf.mp_idx
    is_killed = jnp.where(idx >= 0, kill[jnp.clip(idx, 0)], False)
    kf = m.kf._replace(mp_idx=jnp.where(is_killed, NO_MP, idx))
    return m._replace(kf=kf, mp=mp)


def cull_keyframes(m: MapState, kill: jnp.ndarray) -> MapState:
    """Invalidate keyframes (their features stop observing)."""
    kf = m.kf._replace(
        valid=m.kf.valid & ~kill,
        mp_idx=jnp.where(kill[:, None], NO_MP, m.kf.mp_idx),
    )
    return m._replace(kf=kf)


def update_point_geometry(m: MapState) -> MapState:
    """Recompute normals + scale-distance bands from current observations.

    Replaces `MapPoint::UpdateNormalAndDepth` (ref: MapPoint.cc:~400):
    normal = mean over observing keyframes of normalize(pos - cam_center);
    distance band from the reference keyframe's viewing distance. One
    segment-mean over all observations instead of per-point list walks.
    """
    M = m.mp.capacity
    cam_centers = -jnp.einsum(
        "nji,nj->ni", m.kf.Tcw[:, :3, :3], m.kf.Tcw[:, :3, 3]
    )  # [N, 3] camera centers (R^T applied: Ow = -R^T t)
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.valid[:, None] & m.kf.fvalid
    flat_idx = jnp.where(contrib, idx, 0).reshape(-1)
    w = contrib.reshape(-1).astype(jnp.float32)

    pos_per_obs = m.mp.pos[flat_idx]  # [N*F, 3]
    ctr_per_obs = jnp.repeat(cam_centers, m.kf.n_features, axis=0)
    d = pos_per_obs - ctr_per_obs
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    normal_sum = jax.ops.segment_sum(d * w[:, None], flat_idx, M)
    counts = jax.ops.segment_sum(w, flat_idx, M)
    normal = normal_sum / jnp.maximum(counts, 1.0)[:, None]
    norm_len = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / jnp.maximum(norm_len, 1e-9)
    has_obs = counts > 0

    # Refresh the representative descriptor from the NEWEST observation —
    # the cheap stand-in for ComputeDistinctiveDescriptors' Hamming medoid
    # (MapPoint.cc:~320). Without a refresh, landmark descriptors freeze at
    # creation viewpoint and matching decays as the camera moves.
    F = m.kf.n_features
    key = jnp.where(
        contrib,
        jnp.arange(m.kf.capacity, dtype=jnp.int32)[:, None] * F
        + jnp.arange(F, dtype=jnp.int32)[None, :],
        -1,
    ).reshape(-1)
    newest = jax.ops.segment_max(key, flat_idx, M)  # -inf-ish where no obs
    newest = jnp.where(has_obs, jnp.maximum(newest, 0), 0)
    new_desc = m.kf.desc.reshape(-1, 32)[newest]
    mp = m.mp._replace(
        normal=jnp.where(has_obs[:, None], normal, m.mp.normal),
        desc=jnp.where(has_obs[:, None], new_desc, m.mp.desc),
    )
    return m._replace(mp=mp)


class CompactResult(NamedTuple):
    m: "MapState"
    kf_old2new: jnp.ndarray  # [N] new row per old row, -1 for dropped
    mp_old2new: jnp.ndarray  # [M]
    kf_order: jnp.ndarray    # [N] old row gathered into each new row
    mp_order: jnp.ndarray    # [M]


@jax.jit
def compact(m: MapState) -> CompactResult:
    """Repack valid rows to the front, reclaiming culled slots.

    The allocation cursor is append-only, so culling alone never frees
    capacity — a long run eventually fills the tables even though most
    rows are dead (the reference's std::set maps shrink for free; SURVEY.md
    §5.7 flags eviction as the missing piece of the fixed-capacity design).
    Compaction is a STABLE repack: surviving rows keep their relative
    order, so every time-ordering invariant (per-client spanning chains,
    trailing-window culling, "recent rows are newest") survives with rows
    renumbered. Hosts must remap their row references via `kf_old2new` /
    `mp_old2new` (tracker state, BoW database, loop edges — see
    StereoTracker._compact_map).
    """
    N, M = m.kf.capacity, m.mp.capacity

    def plan(valid, cap):
        order = jnp.argsort(~valid, stable=True)       # valid rows first
        n = jnp.sum(valid.astype(jnp.int32))
        new_of_old = jnp.full(cap, -1, jnp.int32)
        slots = jnp.arange(cap, dtype=jnp.int32)
        new_of_old = new_of_old.at[order].set(
            jnp.where(slots < n, slots, -1))
        return order, new_of_old, n

    kf_order, kf_map, n_kf = plan(m.kf.valid, N)
    mp_order, mp_map, n_mp = plan(m.mp.valid, M)

    kf = jax.tree.map(lambda a: a[kf_order], m.kf)
    mp = jax.tree.map(lambda a: a[mp_order], m.mp)

    # Remap cross-references. A reference to a dropped row becomes invalid.
    idx = kf.mp_idx
    idx = jnp.where(idx >= 0, mp_map[jnp.clip(idx, 0)], NO_MP)
    kf = kf._replace(mp_idx=idx)
    ref = jnp.clip(kf_map[jnp.clip(mp.ref_kf, 0)], 0)
    first = jnp.clip(kf_map[jnp.clip(mp.first_kf, 0)], 0)
    mp = mp._replace(ref_kf=ref, first_kf=first)

    m2 = MapState(kf, mp, n_kf, n_mp)
    return CompactResult(m2, kf_map, mp_map, kf_order, mp_order)
