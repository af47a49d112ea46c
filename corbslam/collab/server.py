"""Map-fusion server: per-client sub-maps, overlap detection, global map
merge, optimization, broadcast.

Replaces `corbslam_server` (ref: src/main.cpp service wiring :49-62;
MapFusion.cpp — service handlers :31-306, fusion loop fuseSubMapToMap
:432, mapFuseToGlobalMap :456, insertServerMapToGlobleMap :622,
detectKeyFrameInServerMap :660, runPubTopic :315, resentGlobalMapToClient
:370; ServerMap.cpp; GlobalOptimize.cpp — server-side Sim3 + CorrectLoop +
GBA; PubToClient.cpp — 4 broadcast topics with per-client TRANSM).

Re-design: every sub-map and the global map are fixed-capacity SoA
MapStates on device; fusion is detect_overlap (dense BoW + batched PnP
RANSAC + Horn Sim3) followed by one whole-map alignment transform and
chunked scatter-merge; post-fusion optimization reuses the loop-closing
pose graph and the chunked-cancellable global BA. The handlers and the
fusion/broadcast loops are explicit step functions — the reference's
thread timers (0.5 Hz scan/pub) become a host scheduler calling steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import sim3
from ..loop import gba as gba_mod
from ..loop import loop_closing as lc
from ..mapstate import mapstate as ms
from ..place import database as db_mod
from ..place import vocab as vocab_mod
from . import fusion_ops, wire
from .client_cache import IdMap
from .transport import Transport


@dataclass
class SubMap:
    """(Cache, Map) pair per client — ServerMap.cpp."""

    map: ms.MapState
    kf_ids: IdMap
    mp_ids: IdMap
    db: db_mod.BowDatabase
    fused: bool = False
    n_kfs_received: int = 0


class MapFusionServer:
    def __init__(
        self,
        cam: cam_mod.Intrinsics,
        cfg: SlamConfig,
        voc: vocab_mod.Vocabulary,
        transport: Transport,
        run_gba: bool = True,
        synchronous_gba: bool = True,
        seed: int = 0,
    ):
        self.cam = cam
        self.cfg = cfg
        self.voc = voc
        self.transport = transport
        self.sub: Dict[int, SubMap] = {}
        cap = cfg.capacity
        self.gmap = ms.empty(cap)
        self.g_kf_ids = IdMap(cap.max_keyframes, 0, cfg.collab.client_id_stride)
        self.g_mp_ids = IdMap(cap.max_map_points, 0, cfg.collab.client_id_stride)
        self.gdb = db_mod.BowDatabase.empty(cap.max_keyframes, voc.n_words)
        # Per-client alignment: sub-map world -> global world (R, t, s) —
        # subMapTransM (MapFusion.h:89). Seeded client gets identity.
        self.transMs: Dict[int, tuple] = {}
        # Broadcast cursors + snapshots (dirty tracking on the global map).
        self._bcast_kf = 0
        self._bcast_mp = 0
        self._kf_pose_snap = np.zeros((cap.max_keyframes, 4, 4), np.float32)
        self._mp_pos_snap = np.zeros((cap.max_map_points, 3), np.float32)
        # Full-map replay cursors (None = no replay in progress).
        self._resync_kf = None
        self._resync_mp = None
        self.gba = gba_mod.GlobalBARunner(
            cam, cfg, synchronous=synchronous_gba
        ) if run_gba else None
        # Seam constraints accumulated across merges — the server-side
        # essential graph's loop edges (GlobalOptimize::CorrectLoop).
        self._loops = lc.LoopEdges.empty()
        self._n_loops = 0
        self._key = jax.random.PRNGKey(seed)
        self.stats = {
            "kfs_received": 0, "mps_received": 0, "fusions": 0,
            "fusion_attempts": 0, "kf_updates": 0, "mp_updates": 0,
            "seam_fuses": 0, "essential_graph_runs": 0,
        }
        transport.register_handler(wire.SRV_INSERT_KFS, self.insert_keyframes)
        transport.register_handler(wire.SRV_INSERT_MPS, self.insert_mappoints)
        transport.register_handler(wire.SRV_UPDATE_KFS, self.update_kf_poses)
        transport.register_handler(wire.SRV_UPDATE_MPS, self.update_mp_positions)
        transport.register_handler(wire.SRV_RESYNC, self.request_resync)

    # ------------------------------------------------------------------
    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _submap(self, cid: int) -> SubMap:
        if cid not in self.sub:
            cap = self.cfg.capacity
            self.sub[cid] = SubMap(
                map=ms.empty(cap),
                kf_ids=IdMap(cap.max_keyframes, cid, self.cfg.collab.client_id_stride),
                mp_ids=IdMap(cap.max_map_points, cid, self.cfg.collab.client_id_stride),
                db=db_mod.BowDatabase.empty(cap.max_keyframes, self.voc.n_words),
            )
        return self.sub[cid]

    # ------------------------------------------------------------------
    # Service handlers (MapFusion.cpp:31-306)
    # ------------------------------------------------------------------

    def _insert_kfs_into(self, m, kf_ids, mp_ids, db, msg,
                         align: Optional[tuple], fixed: bool):
        """Insert keyframe records into a map, optionally re-expressed by
        `align` (sub-world -> dst-world). Returns updated (map, db)."""
        gids = msg["gid"]
        idxs = np.nonzero(~kf_ids.known_mask(gids))[0]
        free = m.kf.capacity - int(m.n_kf)
        idxs = idxs[: max(free, 0)]
        for lo in range(0, len(idxs), fusion_ops.KF_CHUNK):
            sel = idxs[lo:lo + fusion_ops.KF_CHUNK]
            C = fusion_ops.KF_CHUNK
            pad = C - len(sel)

            def P(a, fill=0):
                a = np.asarray(a)[sel]
                if pad:
                    a = np.concatenate(
                        [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]
                    )
                return a

            Tcw = jnp.asarray(P(msg["Tcw"]))
            if align is not None:
                Tcw = fusion_ops.transform_poses(Tcw, align)
            mp_gid = P(msg["mp_gid"], -1)
            mp_rows = np.where(
                mp_gid >= 0,
                mp_ids.rows_for(mp_gid.reshape(-1)).reshape(mp_gid.shape),
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
                fixed=jnp.full(C, fixed),
            )
            rows_np = np.asarray(rows)[: len(sel)]
            kf_ids.assign_foreign(rows_np, gids[sel])
            # BoW vectors for retrieval (vocabulary transform per keyframe).
            bows = vocab_mod.transform_batch(
                self.voc, m.kf.desc[jnp.asarray(rows_np)],
                m.kf.fvalid[jnp.asarray(rows_np)],
            )
            db = db.add_batch(jnp.asarray(rows_np), bows)
        return m, db, len(idxs)

    def _insert_mps_into(self, m, mp_ids, kf_ids, msg,
                         align: Optional[tuple]):
        gids = msg["gid"]
        idxs = np.nonzero(~mp_ids.known_mask(gids))[0]
        free = m.mp.capacity - int(m.n_mp)
        idxs = idxs[: max(free, 0)]
        for lo in range(0, len(idxs), fusion_ops.MP_CHUNK):
            sel = idxs[lo:lo + fusion_ops.MP_CHUNK]
            C = fusion_ops.MP_CHUNK
            pad = C - len(sel)

            def P(a, fill=0):
                a = np.asarray(a)[sel]
                if pad:
                    a = np.concatenate(
                        [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]
                    )
                return a

            pos = jnp.asarray(P(msg["pos"]))
            normal = jnp.asarray(P(msg["normal"]))
            mind = jnp.asarray(P(msg["min_dist"]))
            maxd = jnp.asarray(P(msg["max_dist"]))
            if align is not None:
                R, t, s = align
                pos = sim3.transform(align, pos)
                normal = jnp.einsum("ij,mj->mi", R, normal,
                                    precision=jax.lax.Precision.HIGHEST)
                mind = mind * s
                maxd = maxd * s
            ref_rows = kf_ids.rows_for(P(msg["ref_kf_gid"], -1))
            m, rows = fusion_ops.insert_mp_chunk(
                m, pos, normal, jnp.asarray(P(msg["desc"])),
                mind, maxd, jnp.asarray(P(msg["client"])),
                jnp.asarray(np.clip(ref_rows, 0, None)),
                use=jnp.arange(C) < len(sel),
                fixed=jnp.zeros(C, bool),  # server owns/optimizes everything
            )
            rows_np = np.asarray(rows)[: len(sel)]
            mp_ids.assign_foreign(rows_np, gids[sel])
        return m, len(idxs)

    def insert_keyframes(self, cid: int, msg) -> bool:
        """insertKeyFrameToMap (MapFusion.cpp:31): already-fused clients
        write straight into the global map via their alignment."""
        if self.sub.get(cid) is not None and self.sub[cid].fused:
            align = self._align_tuple(cid)
            self.gmap, self.gdb, n = self._insert_kfs_into(
                self.gmap, self.g_kf_ids, self.g_mp_ids, self.gdb, msg,
                align, fixed=False,
            )
        else:
            sm = self._submap(cid)
            sm.map, sm.db, n = self._insert_kfs_into(
                sm.map, sm.kf_ids, sm.mp_ids, sm.db, msg, None, fixed=False
            )
            sm.n_kfs_received += n
        self.stats["kfs_received"] += n
        return True

    def insert_mappoints(self, cid: int, msg) -> bool:
        if self.sub.get(cid) is not None and self.sub[cid].fused:
            align = self._align_tuple(cid)
            self.gmap, n = self._insert_mps_into(
                self.gmap, self.g_mp_ids, self.g_kf_ids, msg, align
            )
        else:
            sm = self._submap(cid)
            sm.map, n = self._insert_mps_into(
                sm.map, sm.mp_ids, sm.kf_ids, msg, None
            )
        self.stats["mps_received"] += n
        return True

    def update_kf_poses(self, cid: int, msg) -> bool:
        """updateKeyFrameToMap (MapFusion.cpp:172)."""
        fused = self.sub.get(cid) is not None and self.sub[cid].fused
        ids = self.g_kf_ids if fused else self._submap(cid).kf_ids
        rows = ids.rows_for(msg["gid"])
        sel = rows >= 0
        if not sel.any():
            return True
        Tcw = jnp.asarray(msg["Tcw"][sel])
        if fused:
            Tcw = fusion_ops.transform_poses(Tcw, self._align_tuple(cid))
            m = self.gmap
            self.gmap = m._replace(
                kf=m.kf._replace(Tcw=m.kf.Tcw.at[jnp.asarray(rows[sel])].set(Tcw))
            )
        else:
            sm = self.sub[cid]
            m = sm.map
            sm.map = m._replace(
                kf=m.kf._replace(Tcw=m.kf.Tcw.at[jnp.asarray(rows[sel])].set(Tcw))
            )
        self.stats["kf_updates"] += int(sel.sum())
        return True

    def update_mp_positions(self, cid: int, msg) -> bool:
        fused = self.sub.get(cid) is not None and self.sub[cid].fused
        ids = self.g_mp_ids if fused else self._submap(cid).mp_ids
        rows = ids.rows_for(msg["gid"])
        sel = rows >= 0
        if not sel.any():
            return True
        pos = jnp.asarray(msg["pos"][sel])
        if fused:
            pos = sim3.transform(self._align_tuple(cid), pos)
            m = self.gmap
            self.gmap = m._replace(
                mp=m.mp._replace(pos=m.mp.pos.at[jnp.asarray(rows[sel])].set(pos))
            )
        else:
            sm = self.sub[cid]
            m = sm.map
            sm.map = m._replace(
                mp=m.mp._replace(pos=m.mp.pos.at[jnp.asarray(rows[sel])].set(pos))
            )
        self.stats["mp_updates"] += int(sel.sum())
        return True

    def _align_tuple(self, cid: int):
        R, t, s = self.transMs[cid]
        return (jnp.asarray(R), jnp.asarray(t), jnp.asarray(s, jnp.float32))

    # ------------------------------------------------------------------
    # Fusion loop (fuseSubMapToMap, MapFusion.cpp:432)
    # ------------------------------------------------------------------

    def fuse_step(self) -> bool:
        """One scan over unfused sub-maps; returns True if a fusion (or
        seeding) happened."""
        for cid, sm in sorted(self.sub.items()):
            if sm.fused or int(sm.map.n_kf) == 0:
                continue
            if int(self.gmap.n_kf) == 0:
                self._merge_submap(cid, sm, sim3.identity())
                return True
            align = self._try_align(sm)
            self.stats["fusion_attempts"] += 1
            if align is not None:
                (R, t, s), q_sub, cand_old = align
                kf_row_map = self._merge_submap(cid, sm, (R, t, s))
                q_glob = int(kf_row_map[q_sub])
                self._post_fusion_optimize(q_glob, cand_old)
                return True
        return False

    _ALIGN_QUERY_CHUNK = 256   # sub-map keyframes BoW-scored per dispatch
    _ALIGN_VERIFY_MAX = 8      # geometric verifications per fusion attempt

    def _serve_between_steps(self):
        """Drain pending service calls at a safe boundary inside long
        fusion work. The alignment scan can take seconds on a contended
        host; without this every client uplink blocks on its ACK for the
        whole scan (the r4 fleet's 34-136 s t_uplink stalls). Handlers run
        synchronously on THIS thread, so the single-writer discipline is
        preserved; entities inserted mid-scan are merged by _merge_submap's
        own fresh read (or the next scan)."""
        t = getattr(self, "transport", None)
        if t is not None and hasattr(t, "serve_calls"):
            try:
                t.serve_calls()
            except Exception:
                pass

    def _try_align(self, sm: SubMap) -> Optional[tuple]:
        """detectKeyFrameInServerMap over the sub-map's keyframes
        (MapFusion.cpp:488-521), BATCHED: every sub-map keyframe is scored
        against the whole global BoW database in O(n_kf/256) dispatches
        (one transform_batch + one pair-top-k each); only the best few
        (query, candidate) pairs get the expensive geometric verification.
        The reference walks keyframes one BoW query at a time. Returns
        ((R, t, s), q_sub, cand_glob) — the alignment plus the seam
        keyframe pair that produced it."""
        kfv = np.nonzero(np.asarray(sm.map.kf.valid))[0]
        if len(kfv) == 0:
            return None
        QC = self._ALIGN_QUERY_CHUNK
        pairs = []
        for lo in range(0, len(kfv), QC):
            self._serve_between_steps()
            sel = kfv[lo:lo + QC]
            pad = QC - len(sel)
            selj = jnp.asarray(
                np.concatenate([sel, np.zeros(pad, sel.dtype)]) if pad else sel)
            bows = vocab_mod.transform_batch(
                self.voc, sm.map.kf.desc[selj], sm.map.kf.fvalid[selj])
            q_ok = jnp.arange(QC) < len(sel)
            qi, rows, vals, ok = db_mod.detect_map_fusion_pairs(
                self.gdb, self.gmap.kf.valid, bows, q_ok)
            for a, r, v, o in zip(np.asarray(qi), np.asarray(rows),
                                  np.asarray(vals), np.asarray(ok)):
                if o:
                    pairs.append((float(v), int(sel[a]), int(r)))
        pairs.sort(reverse=True)
        for _, q, r in pairs[: self._ALIGN_VERIFY_MAX]:
            self._serve_between_steps()
            res = fusion_ops.detect_overlap(
                self.cam, self.gmap, r, sm.map, q,
                self._next_key(), self.cfg,
            )
            if bool(res.ok):
                return (res.R, res.t, res.s), q, r
        return None

    def _merge_submap(self, cid: int, sm: SubMap, align):
        """insertServerMapToGlobleMap (MapFusion.cpp:622): transform the
        whole sub-map by `align` and append it to the global map, remapping
        landmark references; record the client's alignment; clear the
        sub-map (MapFusion.cpp:523)."""
        R, t, s = align
        moved = fusion_ops.transform_map(sm.map, R, t, s)

        # --- map points first (keyframes reference their rows) ----------
        sub_mp_rows = np.nonzero(np.asarray(moved.mp.valid))[0]
        mp_row_map = np.full(moved.mp.capacity, -1, np.int32)
        g = self.gmap
        for lo in range(0, len(sub_mp_rows), fusion_ops.MP_CHUNK):
            sel = sub_mp_rows[lo:lo + fusion_ops.MP_CHUNK]
            C = fusion_ops.MP_CHUNK
            pad = C - len(sel)
            selj = jnp.asarray(np.concatenate([sel, np.zeros(pad, sel.dtype)])
                               if pad else sel)
            g, rows = fusion_ops.insert_mp_chunk(
                g, moved.mp.pos[selj], moved.mp.normal[selj],
                moved.mp.desc[selj], moved.mp.min_dist[selj],
                moved.mp.max_dist[selj], moved.mp.client[selj],
                jnp.zeros(C, jnp.int32),
                use=jnp.arange(C) < len(sel),
                fixed=jnp.zeros(C, bool),
            )
            rows_np = np.asarray(rows)[: len(sel)]
            mp_row_map[sel] = rows_np
            self.g_mp_ids.assign_foreign(rows_np, sm.mp_ids.gid_of_row[sel])

        # --- keyframes with remapped observations ------------------------
        sub_kf_rows = np.nonzero(np.asarray(moved.kf.valid))[0]
        kf_row_map = np.full(moved.kf.capacity, -1, np.int32)
        mp_idx_all = np.asarray(moved.kf.mp_idx)
        for lo in range(0, len(sub_kf_rows), fusion_ops.KF_CHUNK):
            sel = sub_kf_rows[lo:lo + fusion_ops.KF_CHUNK]
            C = fusion_ops.KF_CHUNK
            pad = C - len(sel)
            selj = jnp.asarray(np.concatenate([sel, np.zeros(pad, sel.dtype)])
                               if pad else sel)
            mp_idx = mp_idx_all[sel]
            mp_idx = np.where(mp_idx >= 0, mp_row_map[np.clip(mp_idx, 0, None)], -1)
            if pad:
                mp_idx = np.concatenate(
                    [mp_idx, np.full((pad, mp_idx.shape[1]), -1, mp_idx.dtype)]
                )
            g, rows = fusion_ops.insert_kf_chunk(
                g, moved.kf.Tcw[selj], moved.kf.xy[selj], moved.kf.octave[selj],
                moved.kf.angle[selj], moved.kf.desc[selj], moved.kf.uright[selj],
                moved.kf.depth[selj], moved.kf.fvalid[selj], jnp.asarray(mp_idx),
                moved.kf.client[selj], moved.kf.frame_id[selj],
                moved.kf.timestamp[selj],
                use=jnp.arange(C) < len(sel),
                fixed=jnp.zeros(C, bool),
            )
            rows_np = np.asarray(rows)[: len(sel)]
            kf_row_map[sel] = rows_np
            self.g_kf_ids.assign_foreign(rows_np, sm.kf_ids.gid_of_row[sel])
            bows = vocab_mod.transform_batch(
                self.voc, g.kf.desc[jnp.asarray(rows_np)],
                g.kf.fvalid[jnp.asarray(rows_np)],
            )
            self.gdb = self.gdb.add_batch(jnp.asarray(rows_np), bows)

        # --- second pass: remap landmark reference keyframes --------------
        # MP chunks were inserted before the keyframes (KFs reference MP
        # rows), so their ref_kf anchors could not be remapped inline; fix
        # them up now so server-side correction propagation (GBA merge-back,
        # essential-graph writeback) moves these points with their true
        # anchor instead of the pinned gauge keyframe.
        ins_mp = sub_mp_rows[mp_row_map[sub_mp_rows] >= 0]
        if len(ins_mp):
            old_ref = np.asarray(moved.mp.ref_kf)[ins_mp]
            new_ref = np.where(
                old_ref >= 0, kf_row_map[np.clip(old_ref, 0, None)], -1
            )
            g = g._replace(mp=g.mp._replace(
                ref_kf=g.mp.ref_kf.at[jnp.asarray(mp_row_map[ins_mp])].set(
                    jnp.asarray(np.clip(new_ref, 0, None))
                )
            ))

        self.gmap = g
        self.transMs[cid] = (np.asarray(R), np.asarray(t), float(s))
        sm.fused = True
        # Clear the sub-map (its content now lives in the global map).
        cap = self.cfg.capacity
        sm.map = ms.empty(cap)
        sm.db = db_mod.BowDatabase.empty(cap.max_keyframes, self.voc.n_words)
        self.stats["fusions"] += 1
        return kf_row_map

    def _post_fusion_optimize(self, kf_q: int, kf_c: int):
        """GlobalOptimize::CorrectLoop (GlobalOptimize.cpp:228-433) after a
        merge, on the server's own global map:

        1. cross-seam SearchAndFuse — project the OLD side's local landmarks
           into the newly merged seam keyframe (and, through relabeled
           bindings, its covisible window) and collapse duplicate landmarks
           (GlobalOptimize.cpp:406 / SearchAndFuse);
        2. essential-graph optimization with the accumulated seam edges
           (GlobalOptimize.cpp:389 -> OptimizeEssentialGraph) — a no-op for
           the first seam (the merge already applied the rigid alignment),
           but it re-distributes error once several seams/updates constrain
           the same keyframes;
        3. global bundle adjustment (GlobalOptimize.cpp:399,435).

        Corrected poses/positions re-broadcast automatically through the
        snapshot-diff in broadcast_step."""
        # 1. Cross-seam duplicate fusion: old-side points into the seam KF
        # twice (the second pass binds features freed by first-pass merges),
        # then seam-side points back into the old candidate keyframe.
        self.gmap = lc.fuse_loop_points(
            self.cam, self.gmap, kf_q, kf_c, self.cfg)
        self.gmap = lc.fuse_loop_points(
            self.cam, self.gmap, kf_c, kf_q, self.cfg)
        self.stats["seam_fuses"] += 1
        self._serve_between_steps()

        # 2. Essential graph over the merged map with the seam edge. The
        # measurement is the CURRENT relative Sim3 (the seam is consistent
        # right after the rigid merge).
        Tq = self.gmap.kf.Tcw[kf_q]
        Tc = self.gmap.kf.Tcw[kf_c]
        Sq = sim3.from_se3(Tq)
        Sc = sim3.from_se3(Tc)
        Rqc, tqc, sqc = sim3.compose(Sq, sim3.inverse(Sc))
        slot = self._n_loops % lc.MAX_LOOP_EDGES
        self._loops = self._loops.add(slot, kf_c, kf_q, Rqc, tqc, sqc)
        self._n_loops += 1
        self.gmap, _costs = lc.optimize_essential_graph(
            self.gmap, self._loops, kf_c, self.gmap.kf.Tcw, self.cfg,
            n_iters=self.cfg.loop.pose_graph_iters,
        )
        self.stats["essential_graph_runs"] += 1
        self._serve_between_steps()

        # 3. Global BA.
        if self.gba is not None:
            self.gba.launch(self.gmap)
            self.gmap = self.gba.try_merge(self.gmap)

    # ------------------------------------------------------------------
    # Broadcast loop (runPubTopic, MapFusion.cpp:315 + PubToClient.cpp)
    # ------------------------------------------------------------------

    def _publish_mp_rows(self, rows: np.ndarray, trans):
        """Publish one batch of global map-point rows on TOPIC_NEW_MPS."""
        m = self.gmap
        msg = wire.mp_insert_msg(
            gid=self.g_mp_ids.gid_of_row[rows],
            client=np.asarray(m.mp.client[jnp.asarray(rows)]),
            pos=np.asarray(m.mp.pos[jnp.asarray(rows)]),
            normal=np.asarray(m.mp.normal[jnp.asarray(rows)]),
            desc=np.asarray(m.mp.desc[jnp.asarray(rows)]),
            min_dist=np.asarray(m.mp.min_dist[jnp.asarray(rows)]),
            max_dist=np.asarray(m.mp.max_dist[jnp.asarray(rows)]),
            ref_kf_gid=np.full(len(rows), -1, np.int64),
        )
        msg.update(trans)
        self.transport.publish(wire.TOPIC_NEW_MPS, msg)

    def _publish_kf_rows(self, rows: np.ndarray, trans):
        """Publish one batch of global keyframe rows on TOPIC_NEW_KFS."""
        m = self.gmap
        rj = jnp.asarray(rows)
        mp_idx = np.asarray(m.kf.mp_idx[rj])
        mp_gid = np.where(
            mp_idx >= 0,
            self.g_mp_ids.gid_of_row[np.clip(mp_idx, 0, None)], -1,
        )
        msg = wire.kf_insert_msg(
            gid=self.g_kf_ids.gid_of_row[rows],
            client=np.asarray(m.kf.client[rj]),
            Tcw=np.asarray(m.kf.Tcw[rj]),
            xy=np.asarray(m.kf.xy[rj]),
            octave=np.asarray(m.kf.octave[rj]),
            angle=np.asarray(m.kf.angle[rj]),
            desc=np.asarray(m.kf.desc[rj]),
            uright=np.asarray(m.kf.uright[rj]),
            depth=np.asarray(m.kf.depth[rj]),
            fvalid=np.asarray(m.kf.fvalid[rj]),
            mp_gid=mp_gid,
            frame_id=np.asarray(m.kf.frame_id[rj]),
            timestamp=np.asarray(m.kf.timestamp[rj]),
        )
        # Ship the BoW vectors the server already computed for its own
        # database in SPARSE form (~8 B/feature): every receiving client
        # with a loop closer then scatters them into its local database
        # instead of re-running the W-word vocabulary transform per
        # foreign keyframe (the r4 worker-cost item; the reference ships
        # mBowVec inside the serialized KeyFrame the same way,
        # KeyFrame.h:60-87 + SerializeObject.h:86-120).
        bow = np.asarray(self.gdb.bow[rj])               # [K, W]
        F = m.kf.n_features
        K = len(rows)
        bids = np.full((K, F), -1, np.int32)
        bvals = np.zeros((K, F), np.float32)
        for k in range(K):
            nz = np.nonzero(bow[k])[0][:F]
            bids[k, : len(nz)] = nz
            bvals[k, : len(nz)] = bow[k, nz]
        msg["bow_ids"] = bids
        msg["bow_vals"] = bvals
        msg.update(trans)
        self.transport.publish(wire.TOPIC_NEW_KFS, msg)

    def request_resync(self, cid: int, msg=None) -> bool:
        """SRV_RESYNC handler: a (late-joining or message-dropping) client
        asks for the whole global map again. Replay starts from row 0 and
        proceeds in resend_chunk_* batches per broadcast tick — the
        reference's chunked resentGlobalMapToClient (MapFusion.cpp:403-423)
        as a pull. Receivers that already know a gid skip it
        (ClientCache._fresh_foreign), so replay is idempotent for everyone
        else on the topic."""
        self._resync_kf = 0
        self._resync_mp = 0
        return True

    def _resync_chunk(self, trans):
        """Emit one chunk of the in-progress full-map replay.

        ALL map-point chunks go out before the first keyframe chunk: a
        replayed KF references MP gids by observation binding, and a dense
        map has >40 obs/KF while the chunk ratio is only 2000 MP : 50 KF —
        replaying them in parallel would hand a KF gids not yet known to
        the receiver, whose _apply_new_kfs maps them to -1 and then skips
        the (now known) KF gid on every later replay, permanently losing
        the bindings (advisor r4, collab/server.py:564)."""
        if self._resync_mp is not None:
            hi = min(self._resync_mp + self.cfg.collab.resend_chunk_mps,
                     self._bcast_mp)
            rows = np.arange(self._resync_mp, hi)
            if len(rows):
                rows = rows[np.asarray(self.gmap.mp.valid[jnp.asarray(rows)])]
            if len(rows):
                self._publish_mp_rows(rows, trans)
            self._resync_mp = hi if hi < self._bcast_mp else None
            return
        if self._resync_kf is not None:
            hi = min(self._resync_kf + self.cfg.collab.resend_chunk_kfs,
                     self._bcast_kf)
            rows = np.arange(self._resync_kf, hi)
            if len(rows):
                rows = rows[np.asarray(self.gmap.kf.valid[jnp.asarray(rows)])]
            if len(rows):
                self._publish_kf_rows(rows, trans)
            self._resync_kf = hi if hi < self._bcast_kf else None

    def broadcast_step(self):
        """Publish new global-map entities and changed poses/positions with
        the per-client TRANSM attached."""
        m = self.gmap
        trans = wire.transm_msg(self.transMs)
        n_kf, n_mp = int(m.n_kf), int(m.n_mp)

        # TRANSM heartbeat: a client fused AFTER the map contents went out
        # would otherwise never see its alignment (no new entities -> no
        # messages -> no TRANSM side channel; the reference re-sends the
        # whole map after every fusion instead, MapFusion.cpp:370). When
        # the alignment set changes, push one empty pose-delta message
        # whose only payload is the TRANSM map.
        tkey = tuple(sorted(self.transMs.keys()))
        if tkey != getattr(self, "_transm_sent", ()):
            hb = wire.kf_pose_msg(np.zeros(0, np.int64),
                                  np.zeros((0, 4, 4), np.float32))
            hb.update(trans)
            self.transport.publish(wire.TOPIC_UPD_KFS, hb)
            self._transm_sent = tkey

        # New map points since last broadcast.
        if n_mp > self._bcast_mp:
            rows = np.arange(self._bcast_mp, n_mp)
            rows = rows[np.asarray(m.mp.valid[jnp.asarray(rows)])]
            if len(rows):
                self._publish_mp_rows(rows, trans)
            self._mp_pos_snap[self._bcast_mp:n_mp] = np.asarray(
                m.mp.pos[self._bcast_mp:n_mp]
            )
            self._bcast_mp = n_mp

        # New keyframes since last broadcast.
        if n_kf > self._bcast_kf:
            rows = np.arange(self._bcast_kf, n_kf)
            rows = rows[np.asarray(m.kf.valid[jnp.asarray(rows)])]
            if len(rows):
                self._publish_kf_rows(rows, trans)
            self._kf_pose_snap[self._bcast_kf:n_kf] = np.asarray(
                m.kf.Tcw[self._bcast_kf:n_kf]
            )
            self._bcast_kf = n_kf

        # In-progress full-map replay for late joiners (MP chunk first so
        # the KF chunk's observation gids resolve on arrival).
        if self._resync_mp is not None or self._resync_kf is not None:
            self._resync_chunk(trans)

        # Updated poses / positions among already-broadcast rows.
        if self._bcast_kf > 0:
            Tcw = np.asarray(m.kf.Tcw[: self._bcast_kf])
            moved = (
                np.abs(Tcw - self._kf_pose_snap[: self._bcast_kf])
                .reshape(len(Tcw), -1).max(axis=1) > 1e-7
            ) & np.asarray(m.kf.valid[: self._bcast_kf])
            rows = np.nonzero(moved)[0]
            if len(rows):
                msg = wire.kf_pose_msg(self.g_kf_ids.gid_of_row[rows], Tcw[rows])
                msg.update(trans)
                self.transport.publish(wire.TOPIC_UPD_KFS, msg)
                self._kf_pose_snap[rows] = Tcw[rows]

        if self._bcast_mp > 0:
            pos = np.asarray(m.mp.pos[: self._bcast_mp])
            movedp = (
                np.abs(pos - self._mp_pos_snap[: self._bcast_mp]).max(axis=1) > 1e-7
            ) & np.asarray(m.mp.valid[: self._bcast_mp])
            rows = np.nonzero(movedp)[0]
            if len(rows):
                msg = wire.mp_pos_msg(self.g_mp_ids.gid_of_row[rows], pos[rows])
                msg.update(trans)
                self.transport.publish(wire.TOPIC_UPD_MPS, msg)
                self._mp_pos_snap[rows] = pos[rows]
