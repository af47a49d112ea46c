"""Client-side collaboration cache: dirty tracking, uplink, downlink.

Replaces the reference's `Cache` memory-managing module + `DataDriver`
RPC client (ref: corbslam_client/src/Cache.cc — dirty sets
newInsertedKFs/updateKFs populated by AddKeyFrameToMap :67 /
addUpdateKeyframe :223; uplink thread runUpdateToServer :322; downlink
subscriptions + handlers :418-634; DataDriver.cc service calls).

Re-design: the map is already SoA device arrays with a monotone
allocation cursor, so "new since last push" is a ROW RANGE, not a dirty
set; "updated poses" is a vectorized diff against the pose snapshot from
the last acknowledged push. Unlike the reference — which snapshots+clears
its dirty sets BEFORE calling the service and silently drops the batch on
failure (DataDriver.cc:70-73, SURVEY.md §5.3) — cursors and snapshots
only advance on ACK, so a failed uplink retries next period.

Identity: own entities get gid = cid * stride + row (the reference's
(clientId-1)*1e6 id offset, KeyFrame.cc:49-51); foreign entities keep the
gid they arrived with, tracked in host-side dicts (the Cache::lKFToKFmap
equivalent).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import sim3
from ..mapstate import mapstate as ms
from . import fusion_ops, wire
from .transport import Transport


class IdMap:
    """Bidirectional row <-> gid bookkeeping for one map's entity class.

    gid = origin_cid * stride + origin-local UID. Own uids come from a
    monotone counter (NOT the row index): map compaction renumbers rows,
    and row-derived gids would collide with the server's existing entities
    once a reclaimed row is reused. Uids stay < stride for any realistic
    run (stride = 1e6), so the reverse map is a dense [cid][gid % stride]
    table, grown on demand — all lookups are vectorized numpy indexing,
    no per-gid Python loops.
    """

    def __init__(self, capacity: int, cid: int, stride: int):
        self.gid_of_row = np.full(capacity, -1, np.int64)
        self._row_of: Dict[int, np.ndarray] = {}  # origin cid -> [local-id] rows
        self.cid = cid
        self.stride = stride
        self.capacity = capacity

    def _table(self, cid: int, need: int = 0) -> np.ndarray:
        t = self._row_of.get(cid)
        if t is None:
            t = np.full(max(self.capacity, need), -1, np.int32)
            self._row_of[cid] = t
        elif need > len(t):
            n = len(t)
            while n < need:
                n *= 2
            t2 = np.full(n, -1, np.int32)
            t2[: len(t)] = t
            self._row_of[cid] = t2
            t = t2
        return t

    def assign_own(self, rows: np.ndarray, uids: np.ndarray):
        rows = np.asarray(rows, np.int64)
        uids = np.asarray(uids, np.int64)
        gids = self.cid * self.stride + uids
        self.gid_of_row[rows] = gids
        t = self._table(self.cid, int(uids.max()) + 1 if len(uids) else 0)
        t[uids] = rows.astype(np.int32)
        return gids

    def assign_foreign(self, rows: np.ndarray, gids: np.ndarray):
        rows = np.asarray(rows, np.int64)
        gids = np.asarray(gids, np.int64)
        self.gid_of_row[rows] = gids
        for c in np.unique(gids // self.stride):
            sel = (gids // self.stride) == c
            loc = gids[sel] % self.stride
            t = self._table(int(c), int(loc.max()) + 1 if len(loc) else 0)
            t[loc] = rows[sel].astype(np.int32)

    def rows_for(self, gids: np.ndarray) -> np.ndarray:
        gids = np.asarray(gids, np.int64)
        out = np.full(gids.shape, -1, np.int32)
        valid = gids >= 0
        for c in np.unique(gids[valid] // self.stride):
            sel = valid & ((gids // self.stride) == c)
            loc = gids[sel] % self.stride
            t = self._table(int(c))
            in_range = loc < len(t)
            vals = np.full(len(loc), -1, np.int32)
            vals[in_range] = t[loc[in_range]]
            out[sel] = vals
        return out

    def known_mask(self, gids: np.ndarray) -> np.ndarray:
        return self.rows_for(gids) >= 0

    def remap_rows(self, old2new: np.ndarray):
        """Apply a map-compaction row permutation: surviving rows keep
        their gids at their new positions; dropped rows' gids retire."""
        old2new = np.asarray(old2new)
        new_gid = np.full_like(self.gid_of_row, -1)
        sel = (self.gid_of_row >= 0) & (old2new >= 0)
        new_gid[old2new[sel]] = self.gid_of_row[sel]
        self.gid_of_row = new_gid
        # Rebuild every reverse table from the surviving forward map.
        rows = np.nonzero(new_gid >= 0)[0]
        gids = new_gid[rows]
        self._row_of = {}
        if len(rows):
            self.assign_foreign(rows, gids)


class ClientCache:
    """Owns sync state for one client's tracker map."""

    def __init__(
        self,
        tracker,                      # frontend.tracking.StereoTracker-like
        transport: Transport,
        cid: int,
        cfg: SlamConfig,
        loop_closer=None,             # gets foreign keyframes into its BoW db
    ):
        self.tracker = tracker
        self.transport = transport
        self.cid = cid
        self.cfg = cfg
        self.loop_closer = loop_closer
        cap = cfg.capacity
        stride = cfg.collab.client_id_stride
        self.kf_ids = IdMap(cap.max_keyframes, cid, stride)
        self.mp_ids = IdMap(cap.max_map_points, cid, stride)
        self.synced_kf = 0   # own rows < cursor AND gid assigned are pushed
        self.synced_mp = 0
        self._kf_pose_snap = np.zeros((cap.max_keyframes, 4, 4), np.float32)
        self._mp_pos_snap = np.zeros((cap.max_map_points, 3), np.float32)
        # Own-world -> global alignment, set by the server via TRANSM.
        self.Ttrans: Optional[tuple] = None
        self.stats = {
            "kfs_pushed": 0, "mps_pushed": 0, "kf_poses_pushed": 0,
            "mp_pos_pushed": 0, "failed_calls": 0,
            "foreign_kfs": 0, "foreign_mps": 0,
        }
        # Serializes uplink (worker thread) against downlink (main thread):
        # both touch the id maps and sync cursors.
        self._lock = threading.Lock()
        self._uq: Optional[queue.Queue] = None
        self._uplink_thread: Optional[threading.Thread] = None
        # Stable per-row identity for OWN entities: uids from a monotone
        # counter, assigned in row order the first time a row is seen by
        # the uplink builder. Row-derived gids would collide after map
        # compaction reuses row numbers (SURVEY.md §5.7).
        self._kf_uid = np.full(cap.max_keyframes, -1, np.int64)
        self._mp_uid = np.full(cap.max_map_points, -1, np.int64)
        self._next_kf_uid = 0
        self._next_mp_uid = 0
        # Bumped by remap_rows (map compaction); an uplink cycle built
        # against the old numbering aborts its commit and retries.
        self._gen = 0
        # Compaction hook: the tracker invokes on_compact callbacks with
        # the CompactResult after repacking.
        if hasattr(tracker, "on_compact"):
            tracker.on_compact.append(self.remap_rows)
        if hasattr(tracker, "on_reset"):
            tracker.on_reset.append(self.handle_reset)
        transport.register_client(cid)

    # ------------------------------------------------------------------
    # Async uplink (the reference's dedicated uplink thread,
    # Cache.cc:322 runUpdateToServer): tracking must not block on the
    # server's ACK — during fusion the server serves no calls for seconds,
    # and a synchronous push stalls the whole frame loop (measured 33% of
    # client wall time in the r3 scaling run). The main thread snapshots
    # the map to host memory (donation-safe: the tracker donates device
    # buffers every frame) and a worker pushes + retries.
    # ------------------------------------------------------------------

    def start_async_uplink(self):
        if self._uq is not None:
            return
        self._uq = queue.Queue(maxsize=1)
        self._uplink_thread = threading.Thread(
            target=self._uplink_worker, daemon=True)
        self._uplink_thread.start()

    def request_uplink(self) -> bool:
        """Queue one uplink cycle against a host snapshot of the current
        map; skipped (False) while the previous cycle is still in flight —
        cursors only advance on ACK, so nothing is lost."""
        if self._uq is None:
            return self.uplink_step()
        if self._uq.full():
            return False
        snap = jax.tree.map(np.asarray, self.tracker.map)
        self._uq.put(snap)
        return True

    def _uplink_worker(self):
        while True:
            snap = self._uq.get()
            if snap is None:
                return
            try:
                self.uplink_step(snap)
            except Exception:  # pragma: no cover - keep the worker alive
                import traceback

                traceback.print_exc()

    def stop_async_uplink(self):
        if self._uq is None:
            return
        self._uq.put(None)
        self._uplink_thread.join(timeout=30)
        self._uq = None
        self._uplink_thread = None

    # ------------------------------------------------------------------
    # Uplink (runUpdateToServer, Cache.cc:322)
    # ------------------------------------------------------------------

    def uplink_step(self, m: Optional[ms.MapState] = None) -> bool:
        """One sync cycle: push new map points, new keyframes, then pose /
        position deltas. Returns True if everything was acknowledged.
        `m` may be a host-side numpy snapshot (async worker path).

        Map points MUST be acked before the keyframes that observe them go
        out: kf_insert_msg encodes observations as mp gids via
        `mp_ids.gid_of_row`, which is only assigned on MP ack. Pushing KFs
        after a failed MP push would wire-encode those observations as -1
        and the server (which then marks the KF gid known) would never
        re-receive the bindings — so a failed MP push aborts the cycle and
        the whole batch retries next period.

        Locking: the transport call can block for SECONDS while the server
        is fusion-busy; holding the cache lock across it would stall the
        main thread's downlink_step (the stall the async uplink exists to
        remove). Each push therefore builds its message and commits its
        cursors/id maps under the lock, but performs I/O outside it —
        safe because only this single uplink worker advances cursors and
        assigns OWN rows, while downlink only assigns FOREIGN rows."""
        if m is None:
            m = self.tracker.map
        for build in (self._build_new_mps, self._build_new_kfs,
                      self._build_pose_deltas, self._build_pos_deltas):
            with self._lock:
                gen = self._gen
                prep = build(m)
            if prep is None:
                continue  # nothing to push for this stage
            service, msg, commit = prep
            if not self.transport.call(service, self.cid, msg):
                self.stats["failed_calls"] += 1
                return False
            with self._lock:
                if self._gen != gen:
                    # Map compacted mid-flight: the build's row numbering
                    # is stale. Abort the cycle; the next period re-pushes
                    # the same GIDS (stable uids), which the server
                    # deduplicates — nothing is lost or duplicated.
                    return False
                commit()
        return True

    def _own_new_rows(self, client_arr, valid_arr, lo: int, hi: int, fixed_arr):
        rows = np.arange(lo, hi, dtype=np.int64)
        if len(rows) == 0:
            return rows
        cl = np.asarray(client_arr[lo:hi])
        vd = np.asarray(valid_arr[lo:hi])
        fx = np.asarray(fixed_arr[lo:hi])
        return rows[(cl == self.cid) & vd & ~fx]

    def _kf_uids_up_to(self, hi: int) -> np.ndarray:
        """Assign uids (monotone, row order) to keyframe rows < hi that
        lack one; returns the row->uid view. Called under the lock."""
        missing = np.nonzero(self._kf_uid[:hi] < 0)[0]
        if len(missing):
            self._kf_uid[missing] = np.arange(
                self._next_kf_uid, self._next_kf_uid + len(missing))
            self._next_kf_uid += len(missing)
        return self._kf_uid

    def _mp_uids_up_to(self, hi: int) -> np.ndarray:
        missing = np.nonzero(self._mp_uid[:hi] < 0)[0]
        if len(missing):
            self._mp_uid[missing] = np.arange(
                self._next_mp_uid, self._next_mp_uid + len(missing))
            self._next_mp_uid += len(missing)
        return self._mp_uid

    def _build_new_mps(self, m: ms.MapState):
        """Build the new-map-point push (called under the lock). Returns
        (service, msg, commit) or None; `commit` runs under the lock after
        the server ACKs."""
        hi = int(m.n_mp)
        rows = self._own_new_rows(m.mp.client, m.mp.valid, self.synced_mp, hi,
                                  m.mp.fixed)
        if len(rows) == 0:
            self.synced_mp = hi
            return None
        uids = self._mp_uids_up_to(hi)[rows]
        gids = self.cid * self.mp_ids.stride + uids
        ref_rows = np.asarray(m.mp.ref_kf[rows])
        kf_uid = self._kf_uids_up_to(int(m.n_kf))
        ref_uid = kf_uid[np.clip(ref_rows, 0, None)]
        pos = np.asarray(m.mp.pos[rows])
        msg = wire.mp_insert_msg(
            gid=gids, client=np.full(len(rows), self.cid, np.int32),
            pos=pos,
            normal=np.asarray(m.mp.normal[rows]),
            desc=np.asarray(m.mp.desc[rows]),
            min_dist=np.asarray(m.mp.min_dist[rows]),
            max_dist=np.asarray(m.mp.max_dist[rows]),
            ref_kf_gid=np.where(
                ref_rows >= 0,
                self.cid * self.kf_ids.stride + ref_uid, -1
            ).astype(np.int64),
        )

        def commit():
            self.mp_ids.assign_own(rows, uids)
            self._mp_pos_snap[rows] = pos
            self.synced_mp = hi
            self.stats["mps_pushed"] += len(rows)

        return wire.SRV_INSERT_MPS, msg, commit

    def _build_new_kfs(self, m: ms.MapState):
        hi = int(m.n_kf)
        rows = self._own_new_rows(m.kf.client, m.kf.valid, self.synced_kf, hi,
                                  m.kf.fixed)
        if len(rows) == 0:
            self.synced_kf = hi
            return None
        uids = self._kf_uids_up_to(hi)[rows]
        gids = self.cid * self.kf_ids.stride + uids
        mp_idx = np.asarray(m.kf.mp_idx[rows])  # [K, F] local rows
        mp_gid = np.where(
            mp_idx >= 0, self.mp_ids.gid_of_row[np.clip(mp_idx, 0, None)], -1
        )
        Tcw = np.asarray(m.kf.Tcw[rows])
        msg = wire.kf_insert_msg(
            gid=gids, client=np.full(len(rows), self.cid, np.int32),
            Tcw=Tcw,
            xy=np.asarray(m.kf.xy[rows]),
            octave=np.asarray(m.kf.octave[rows]),
            angle=np.asarray(m.kf.angle[rows]),
            desc=np.asarray(m.kf.desc[rows]),
            uright=np.asarray(m.kf.uright[rows]),
            depth=np.asarray(m.kf.depth[rows]),
            fvalid=np.asarray(m.kf.fvalid[rows]),
            mp_gid=mp_gid,
            frame_id=np.asarray(m.kf.frame_id[rows]),
            timestamp=np.asarray(m.kf.timestamp[rows]),
        )

        def commit():
            self.kf_ids.assign_own(rows, uids)
            self._kf_pose_snap[rows] = Tcw
            self.synced_kf = hi
            self.stats["kfs_pushed"] += len(rows)

        return wire.SRV_INSERT_KFS, msg, commit

    def _build_pose_deltas(self, m: ms.MapState):
        """Keyframes already on the server whose pose moved (local BA, loop
        correction) — the reference's updateKFs dirty set (Cache.cc:223),
        here a vectorized diff against the last acked snapshot."""
        lo = self.synced_kf
        own = (self.kf_ids.gid_of_row >= 0) & (
            np.arange(len(self.kf_ids.gid_of_row)) < lo
        )
        if not own.any():
            return None
        Tcw = np.asarray(m.kf.Tcw)
        moved = own & (
            np.abs(Tcw - self._kf_pose_snap).reshape(len(Tcw), -1).max(axis=1)
            > 1e-7
        ) & np.asarray(m.kf.valid) & ~np.asarray(m.kf.fixed)
        rows = np.nonzero(moved)[0]
        if len(rows) == 0:
            return None
        msg = wire.kf_pose_msg(self.kf_ids.gid_of_row[rows], Tcw[rows])

        def commit():
            self._kf_pose_snap[rows] = Tcw[rows]
            self.stats["kf_poses_pushed"] += len(rows)

        return wire.SRV_UPDATE_KFS, msg, commit

    def _build_pos_deltas(self, m: ms.MapState):
        lo = self.synced_mp
        own = (self.mp_ids.gid_of_row >= 0) & (
            np.arange(len(self.mp_ids.gid_of_row)) < lo
        )
        if not own.any():
            return None
        pos = np.asarray(m.mp.pos)
        moved = own & (
            np.abs(pos - self._mp_pos_snap).max(axis=1) > 1e-7
        ) & np.asarray(m.mp.valid) & ~np.asarray(m.mp.fixed)
        rows = np.nonzero(moved)[0]
        if len(rows) == 0:
            return None
        msg = wire.mp_pos_msg(self.mp_ids.gid_of_row[rows], pos[rows])

        def commit():
            self._mp_pos_snap[rows] = pos[rows]
            self.stats["mp_pos_pushed"] += len(rows)

        return wire.SRV_UPDATE_MPS, msg, commit

    def remap_rows(self, res) -> None:
        """Apply a map compaction (mapstate.CompactResult) to every
        row-addressed structure: id maps, uid tables, ack snapshots, and
        the sync cursors (stable repack: surviving rows below a cursor
        stay below it, so the cursor becomes the survivor count). Bumps
        the generation so an uplink cycle built against the old numbering
        aborts its commit — with stable uids the retry re-sends the same
        gids and the server deduplicates. This is what lets §5.7
        compaction stay ENABLED under collaboration (the r3 gap)."""
        kmap = np.asarray(res.kf_old2new)
        pmap = np.asarray(res.mp_old2new)
        with self._lock:
            self._gen += 1
            self.kf_ids.remap_rows(kmap)
            self.mp_ids.remap_rows(pmap)

            def permute(arr, old2new, fill):
                out = np.full_like(arr, fill)
                sel = old2new >= 0
                out[old2new[sel]] = arr[sel]
                return out

            self._kf_uid = permute(self._kf_uid, kmap, -1)
            self._mp_uid = permute(self._mp_uid, pmap, -1)
            self._kf_pose_snap = permute(self._kf_pose_snap, kmap, 0.0)
            self._mp_pos_snap = permute(self._mp_pos_snap, pmap, 0.0)
            self.synced_kf = int((kmap[: self.synced_kf] >= 0).sum())
            self.synced_mp = int((pmap[: self.synced_mp] >= 0).sum())

    def handle_reset(self) -> None:
        """Apply a tracker hard reset (Tracking::Reset, Tracking.cc:1533):
        every row-addressed structure starts over with the empty map. The
        uid counters stay MONOTONE — entities already pushed live on at the
        server as a dead sub-map (the reference's Reset does not retract
        served keyframes either) and re-used uids would collide with them.
        A resync request repopulates the foreign (global-map) entities the
        reset threw away."""
        cap = self.cfg.capacity
        stride = self.cfg.collab.client_id_stride
        with self._lock:
            self._gen += 1
            self.kf_ids = IdMap(cap.max_keyframes, self.cid, stride)
            self.mp_ids = IdMap(cap.max_map_points, self.cid, stride)
            self.synced_kf = 0
            self.synced_mp = 0
            self._kf_pose_snap[:] = 0.0
            self._mp_pos_snap[:] = 0.0
            self._kf_uid[:] = -1
            self._mp_uid[:] = -1
        try:
            self.request_resync()
        except Exception:  # transport may be gone at shutdown
            pass

    def request_resync(self) -> bool:
        """Ask the server to replay the full global map in chunks — the
        late-join / lost-message recovery path (the reference re-sends the
        whole map after every fusion, MapFusion.cpp:370-423; here it is a
        pull so steady-state broadcasts stay delta-only). The replay
        arrives on the normal downlink topics; gids this client already
        knows are skipped by _fresh_foreign."""
        return self.transport.call(wire.SRV_RESYNC, self.cid, {})

    # ------------------------------------------------------------------
    # Downlink (Cache::runSubFromServer + handlers, Cache.cc:418-634)
    # ------------------------------------------------------------------

    def downlink_step(self):
        """Drain all four topics and apply them to the local map."""
        with self._lock:
            for msg in self.transport.poll(wire.TOPIC_NEW_MPS, self.cid):
                self._note_transm(msg)
                self._apply_new_mps(msg)
            for msg in self.transport.poll(wire.TOPIC_NEW_KFS, self.cid):
                self._note_transm(msg)
                self._apply_new_kfs(msg)
            for msg in self.transport.poll(wire.TOPIC_UPD_KFS, self.cid):
                self._note_transm(msg)
                self._apply_kf_poses(msg)
            for msg in self.transport.poll(wire.TOPIC_UPD_MPS, self.cid):
                self._note_transm(msg)
                self._apply_mp_pos(msg)

    def _note_transm(self, msg):
        """Record this client's alignment transform from the message's
        TRANSM map REGARDLESS of whether any entity in the message is
        applied. The reference attaches TRANSM to every downlink message
        (PubToClient.cpp:48-52) precisely so clients learn their alignment
        as a side channel; the r4 scaling artifacts showed has_transm=false
        on every fused client because the handlers' early returns (already-
        known gids) skipped the lookup."""
        tr = wire.transm_lookup(msg, self.cid)
        if tr is not None:
            self.Ttrans = tr

    def _own_transform_inv(self, msg):
        tr = wire.transm_lookup(msg, self.cid)
        if tr is not None:
            self.Ttrans = tr
        if self.Ttrans is None:
            return sim3.identity()
        R, t, s = self.Ttrans
        return sim3.inverse((jnp.asarray(R), jnp.asarray(t), jnp.float32(s)))

    def _fresh_foreign(self, gids: np.ndarray, idmap: IdMap) -> np.ndarray:
        """Mask of entities to insert: not ours, not already known
        (Cache.cc:471-474 skips own-client and existing ids)."""
        own = (gids // idmap.stride) == self.cid
        return ~own & ~idmap.known_mask(gids)

    def _apply_new_mps(self, msg):
        gids = msg["gid"]
        take = self._fresh_foreign(gids, self.mp_ids)
        if not take.any():
            return
        Sinv = self._own_transform_inv(msg)
        m = self.tracker.map
        free = m.mp.capacity - int(m.n_mp)
        idxs = np.nonzero(take)[0][: max(free, 0)]
        for lo in range(0, len(idxs), fusion_ops.MP_CHUNK):
            sel = idxs[lo:lo + fusion_ops.MP_CHUNK]
            C = fusion_ops.MP_CHUNK
            pad = C - len(sel)
            def P(a, fill=0):
                a = np.asarray(a)[sel]
                return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a
            pos = sim3.transform(Sinv, jnp.asarray(P(msg["pos"])))
            normal = jnp.einsum("ij,mj->mi", Sinv[0], jnp.asarray(P(msg["normal"])),
                                precision=jax.lax.Precision.HIGHEST)
            m, rows = fusion_ops.insert_mp_chunk(
                m, pos, normal, jnp.asarray(P(msg["desc"])),
                jnp.asarray(P(msg["min_dist"])) * float(Sinv[2]),
                jnp.asarray(P(msg["max_dist"])) * float(Sinv[2]),
                jnp.asarray(P(msg["client"])),
                jnp.zeros(C, jnp.int32),
                use=jnp.arange(C) < len(sel),
                fixed=jnp.ones(C, bool),  # foreign data is read-only (:534)
            )
            rows_np = np.asarray(rows)[: len(sel)]
            self.mp_ids.assign_foreign(rows_np, gids[sel])
            self.stats["foreign_mps"] += len(sel)
        self.tracker.map = m

    def _apply_new_kfs(self, msg):
        gids = msg["gid"]
        take = self._fresh_foreign(gids, self.kf_ids)
        if not take.any():
            return
        Sinv = self._own_transform_inv(msg)
        m = self.tracker.map
        free = m.kf.capacity - int(m.n_kf)
        idxs = np.nonzero(take)[0][: max(free, 0)]
        for lo in range(0, len(idxs), fusion_ops.KF_CHUNK):
            sel = idxs[lo:lo + fusion_ops.KF_CHUNK]
            C = fusion_ops.KF_CHUNK
            pad = C - len(sel)
            def P(a, fill=0):
                a = np.asarray(a)[sel]
                return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a
            Tcw = fusion_ops.transform_poses(jnp.asarray(P(msg["Tcw"])), Sinv)
            mp_gid = P(msg["mp_gid"], -1)
            mp_rows = np.where(
                mp_gid >= 0,
                self.mp_ids.rows_for(mp_gid.reshape(-1)).reshape(mp_gid.shape),
                -1,
            )
            m, rows = fusion_ops.insert_kf_chunk(
                m, Tcw,
                jnp.asarray(P(msg["xy"])), jnp.asarray(P(msg["octave"])),
                jnp.asarray(P(msg["angle"])), jnp.asarray(P(msg["desc"])),
                jnp.asarray(P(msg["uright"])), jnp.asarray(P(msg["depth"])),
                jnp.asarray(P(msg["fvalid"], False)), jnp.asarray(mp_rows),
                jnp.asarray(P(msg["client"])),
                jnp.asarray(P(msg["frame_id"])),
                jnp.asarray(P(msg["timestamp"])),
                use=jnp.arange(C) < len(sel),
                fixed=jnp.ones(C, bool),  # setFixed (Cache.cc:482)
            )
            rows_np = np.asarray(rows)[: len(sel)]
            self.kf_ids.assign_foreign(rows_np, gids[sel])
            self.stats["foreign_kfs"] += len(sel)
            # Keep the tracker's host mirror of the keyframe cursor exact
            # (it gates keyframe creation without a device sync).
            if hasattr(self.tracker, "_kf_cursor_est"):
                self.tracker._kf_cursor_est = max(
                    self.tracker._kf_cursor_est, int(rows_np.max()) + 1)
            # Foreign keyframes join the local BoW database so they serve
            # relocalization and loop detection (Cache.cc:484
            # addKeyFrametoDB). Batched: one transform_many + one scatter
            # per chunk instead of a device program per row (the per-row
            # loop was a measurable slice of r3's downlink cost).
            if self.loop_closer is not None and len(rows_np):
                from ..place import vocab as vocab_mod

                lc = self.loop_closer
                rj = jnp.asarray(rows_np)
                if "bow_ids" in msg:
                    # Server shipped the BoW sparsely — scatter, don't
                    # recompute the W-word transform (r4 worker cost).
                    ids = jnp.asarray(P(msg["bow_ids"], -1))
                    vals = jnp.asarray(P(msg["bow_vals"], 0.0))
                    W = lc.voc.n_words
                    bows = jnp.zeros((C, W), jnp.float32).at[
                        jnp.arange(C)[:, None], jnp.clip(ids, 0)
                    ].add(jnp.where(ids >= 0, vals, 0.0))[: len(sel)]
                else:
                    bows = vocab_mod.transform_many(
                        lc.voc, m.kf.desc[rj], m.kf.fvalid[rj])
                lc.db = lc.db.add_batch(rj, bows)
        self.tracker.map = m

    @staticmethod
    def _pow2_pad(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _apply_kf_poses(self, msg):
        """Server-optimized poses for FIXED (foreign) keyframes only — own
        entities are authoritative locally (Cache.cc:574).

        Inputs are padded to power-of-two buckets: every distinct delta
        count otherwise compiles a fresh scatter program DURING the timed
        window (each server optimization broadcast moves a different
        number of keyframes); padding rows scatter out of bounds and are
        dropped."""
        gids = msg["gid"]
        rows = self.kf_ids.rows_for(gids)
        m = self.tracker.map
        fixed = np.asarray(m.kf.fixed)
        sel = (rows >= 0) & fixed[np.clip(rows, 0, None)]
        n = int(sel.sum())
        if n == 0:
            return
        Sinv = self._own_transform_inv(msg)
        B = self._pow2_pad(n)
        T_in = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        T_in[:n] = msg["Tcw"][sel]
        r_in = np.full(B, m.kf.capacity, np.int32)  # OOB -> dropped
        r_in[:n] = rows[sel]
        Tcw = fusion_ops.transform_poses(jnp.asarray(T_in), Sinv)
        self.tracker.map = m._replace(
            kf=m.kf._replace(
                Tcw=m.kf.Tcw.at[jnp.asarray(r_in)].set(Tcw, mode="drop"))
        )

    def _apply_mp_pos(self, msg):
        gids = msg["gid"]
        rows = self.mp_ids.rows_for(gids)
        m = self.tracker.map
        fixed = np.asarray(m.mp.fixed)
        sel = (rows >= 0) & fixed[np.clip(rows, 0, None)]
        n = int(sel.sum())
        if n == 0:
            return
        Sinv = self._own_transform_inv(msg)
        B = self._pow2_pad(n)
        p_in = np.zeros((B, 3), np.float32)
        p_in[:n] = msg["pos"][sel]
        r_in = np.full(B, m.mp.capacity, np.int32)
        r_in[:n] = rows[sel]
        pos = sim3.transform(Sinv, jnp.asarray(p_in))
        self.tracker.map = m._replace(
            mp=m.mp._replace(
                pos=m.mp.pos.at[jnp.asarray(r_in)].set(pos, mode="drop"))
        )
