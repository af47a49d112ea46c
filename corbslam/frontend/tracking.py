"""Host-side tracking state machine.

The control-flow half of the reference's `Tracking` thread (ref:
corbslam_client/src/Tracking.cc:266 Track(), :414 OK/LOST state machine,
:995 NeedNewKeyFrame): a small Python object that sequences the jitted
device programs in frontend/track_ops.py and mapping/local_mapping.py.
All numerics live on device; the host only branches on scalar summaries
(inlier counts, state flags) — the batched replacement for the
reference's 6 mutex-coupled threads (SURVEY.md §2.4 P1).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapping import local_mapping, triangulation
from ..mapstate import mapstate as ms
from ..matching import matcher
from . import frame as frame_mod
from . import track_ops


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerStats:
    n_frames: int = 0
    n_keyframes: int = 0
    n_relocalizations: int = 0
    n_resets: int = 0
    n_compactions: int = 0
    inliers_history: list = field(default_factory=list)


class StereoTracker:
    """Single-client stereo/RGB-D tracking + local mapping pipeline.

    Equivalent scope: System + Tracking + LocalMapping for the stereo path
    (the minimum end-to-end slice of SURVEY.md §7.2 step 5).
    """

    def __init__(
        self,
        cam: cam_mod.Intrinsics,
        cfg: SlamConfig,
        client: int = 0,
        loop_closer=None,
    ):
        self.cam = cam
        self.cfg = cfg
        self.client = client
        self.loop_closer = loop_closer  # loop.loop_closing.LoopCloser or None
        self.map = ms.empty(cfg.capacity)
        self._state = TrackState.NOT_INITIALIZED
        self.last_frame: Optional[frame_mod.FrameData] = None
        self.velocity = jnp.eye(4)  # T_cur_last
        self.last_kf_frame_id = 0
        self.frame_id = 0
        self.ref_kf = 0
        self._ref_kf_dev = jnp.int32(0)  # device copy for pipelined dispatch
        # In-flight fused frames, retired cfg.tracking.pipeline_depth frames
        # late so the summary sync never waits on live device compute.
        self._pending: deque = deque()
        # Frame pair buffer for frames_per_dispatch=2 (one program tracks
        # two consecutive frames; see track_ops.track_frame_stereo2).
        self._pair_buf: list = []
        # Deferred per-keyframe mapping stages (the reference's LocalMapping
        # THREAD, LocalMapping.cc:44): each entry is one device program,
        # executed one per frame so keyframe frames stop paying the whole
        # insert+fuse+cull+BA pipeline inline (r3: 100-250 ms spikes).
        self._stage_q: deque = deque()
        self.ref_obs = 0  # tracked-point count when the last KF was made
        self.scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
        self._traj: list = []  # (timestamp, Tcw np [4,4])
        self._frame_states: list = []  # TrackState per processed frame
        self.stats = TrackerStats()
        self.mapping_queue_enabled = True
        # Row compaction (SURVEY.md §5.7 eviction): when the append-only
        # keyframe cursor nears capacity, repack valid rows to the front
        # and remap host references. Subscribers with row-addressed state
        # (the collab ClientCache) register on_compact callbacks and are
        # remapped atomically with the repack.
        self.compaction_enabled = True
        self.on_compact: list = []
        self.on_reset: list = []
        # Bumped whenever keyframe poses move OUTSIDE the local-BA stages
        # (loop correction, GBA merge, compaction): a split local BA whose
        # window was built before the bump aborts its writeback — the
        # reference's mbAbortBA on loop events (LocalMapping.cc:79,
        # LoopClosing.cc:420). Writing back a pre-loop linearization would
        # silently UNDO the loop correction for the window keyframes.
        self.map_epoch = 0
        self._kf_cursor_est = 0  # host estimate of the device cursor
        self._compact_cooldown = 0  # frame id gate after a fruitless repack
        self.sensor = "stereo"
        self._init_ref = None  # mono two-view init reference frame
        self._reloc_key = jax.random.PRNGKey(client + 17)
        K1 = cfg.capacity.local_window_kfs
        self._local_rows = jnp.zeros(K1, jnp.int32)
        self._local_ok = jnp.zeros(K1, bool)

    # ------------------------------------------------------------------
    # External views. Reads FLUSH the in-flight pipelined frame first so
    # callers (apps, caches, tests) always see a consistent retired state;
    # internal code uses the underscored fields to keep the pipeline deep.
    # ------------------------------------------------------------------
    @property
    def state(self) -> "TrackState":
        self.flush()
        return self._state

    @state.setter
    def state(self, v):
        self._state = v

    @property
    def trajectory(self) -> list:
        self.flush()
        return self._traj

    @property
    def frame_states(self) -> list:
        self.flush()
        return self._frame_states

    # ------------------------------------------------------------------
    def process_stereo(self, img_l, img_r, timestamp: float):
        self.sensor = "stereo"
        return self._process("stereo", (img_l, img_r), timestamp)

    def process_rgbd(self, img, depth_map, timestamp: float):
        self.sensor = "rgbd"
        return self._process("rgbd", (img, depth_map), timestamp)

    def process_mono(self, img, timestamp: float):
        """Monocular ingest — `System::TrackMonocular` (System.cc:185)."""
        self.sensor = "mono"
        return self._process("mono", (img,), timestamp)

    def _process(self, sensor: str, images, timestamp: float):
        if self._state == TrackState.OK:
            return self._dispatch_fused(sensor, images, timestamp)
        self.flush()  # the in-flight frame decides the real state
        if self._state == TrackState.OK:
            return self._dispatch_fused(sensor, images, timestamp)
        if sensor == "stereo":
            cur = frame_mod.build_frame_stereo(
                images[0], images[1], self.cam, self.cfg.orb)
        elif sensor == "rgbd":
            cur = frame_mod.build_frame_rgbd(
                images[0], images[1], self.cam, self.cfg.orb)
        else:
            cur = frame_mod.build_frame_mono(images[0], self.cam, self.cfg.orb)
        return self._track(cur, timestamp)

    # ------------------------------------------------------------------
    # Pipelined OK-state path: ONE fused device program per frame
    # (track_ops.track_frame_*), retired one frame later so its summary
    # sync (~1 dispatch round trip) overlaps the next frame's compute —
    # the equivalent of the reference's tracking/mapping thread
    # overlap (SURVEY.md §2.4 P1).
    # ------------------------------------------------------------------
    def _dispatch_fused(self, sensor: str, images, timestamp: float):
        if (self.compaction_enabled
                and self.frame_id >= self._compact_cooldown
                and self._kf_cursor_est
                >= int(0.85 * self.cfg.capacity.max_keyframes)):
            self.flush()
            self._compact_map()
        if self.loop_closer is not None:
            m2 = self.loop_closer.try_merge_gba(self.map)
            if m2 is not self.map:
                self.map_epoch += 1  # GBA merge moved poses
                self.map = m2

        # Amortized local mapping: run one deferred stage per frame, then
        # keep draining while the backlog exceeds a small bound, so mapping
        # compute spreads across the frames between keyframes WITHOUT the
        # queue ever growing unboundedly. (r4 regression: the 3-stage local
        # BA raised production to ~6.5 stages/KF while consumption stayed
        # at <=2/frame; on keyframe-dense runs the whole mapping+loop
        # pipeline then deferred to shutdown flush, where loop closure
        # fired on a map state far from the one it was detected in.)
        if self._stage_q:
            self._run_stage()
            while len(self._stage_q) > 4:
                self._run_stage()

        kwargs = dict(
            ref_kf=self._ref_kf_dev,
            prev_local_rows=self._local_rows,
            prev_local_ok=self._local_ok,
            cam=self.cam, cfg=self.cfg,
        )
        if (self.cfg.tracking.frames_per_dispatch >= 2
                and sensor == "stereo"):
            # Buffer one frame; dispatch both in ONE program.
            self._pair_buf.append((images, timestamp))
            if len(self._pair_buf) < 2:
                return self.current_pose()
            (im0, t0), (im1, t1) = self._pair_buf
            self._pair_buf.clear()
            o0, o1 = track_ops.track_frame_stereo2(
                self.map, self.last_frame, self.velocity,
                im0[0], im0[1], im1[0], im1[1], **kwargs)
            outs = ((o0, t0), (o1, t1))
        elif sensor == "stereo":
            out = track_ops.track_frame_stereo(
                self.map, self.last_frame, self.velocity, images[0], images[1],
                **kwargs)
            outs = ((out, timestamp),)
        elif sensor == "rgbd":
            out = track_ops.track_frame_rgbd(
                self.map, self.last_frame, self.velocity, images[0], images[1],
                **kwargs)
            outs = ((out, timestamp),)
        else:
            out = track_ops.track_frame_mono(
                self.map, self.last_frame, self.velocity, images[0], **kwargs)
            outs = ((out, timestamp),)

        # Advance the device-side state immediately (all async).
        out = outs[-1][0]
        self.map = out.map
        self.last_frame = out.cur
        self.velocity = out.velocity
        self._local_rows = out.local_rows
        self._local_ok = out.local_ok
        self._ref_kf_dev = out.ref_kf
        for o, ts in outs:
            # Start the device->host copy of the summary NOW; by the time
            # this frame retires (pipeline_depth frames later) the bytes
            # are already on the host and np.asarray is a no-wait read.
            try:
                o.summary.copy_to_host_async()
            except AttributeError:  # older jax array types
                pass
            self._pending.append((o, ts, self.frame_id))
            self.frame_id += 1
        while len(self._pending) > self.cfg.tracking.pipeline_depth:
            self._retire(*self._pending.popleft())
        return self.current_pose()

    def flush(self):
        """Retire all in-flight pipelined frames and drain the deferred
        mapping stages, leaving a fully consistent map."""
        if self._pair_buf:
            # Odd buffered frame: dispatch it through the 1-frame program.
            (im, ts), = self._pair_buf
            self._pair_buf.clear()
            out = track_ops.track_frame_stereo(
                self.map, self.last_frame, self.velocity, im[0], im[1],
                ref_kf=self._ref_kf_dev,
                prev_local_rows=self._local_rows,
                prev_local_ok=self._local_ok,
                cam=self.cam, cfg=self.cfg)
            self.map = out.map
            self.last_frame = out.cur
            self.velocity = out.velocity
            self._local_rows = out.local_rows
            self._local_ok = out.local_ok
            self._ref_kf_dev = out.ref_kf
            self._pending.append((out, ts, self.frame_id))
            self.frame_id += 1
        while self._pending:
            self._retire(*self._pending.popleft())
        while self._stage_q:
            self._run_stage()

    def _retire(self, out, timestamp: float, fid: int):
        """Consume a fused frame's summary (the one host sync): state
        machine, trajectory, keyframe policy — the host half of Track()."""
        s = np.asarray(out.summary)
        n_track, n_local = int(s[0]), int(s[2])
        Tcw_np = s[8:24].reshape(4, 4).copy()
        cur = out.cur
        self._traj.append((timestamp, Tcw_np))
        self.stats.n_frames += 1

        lost = (n_track < self.cfg.tracking.min_inliers_motion
                or n_local < self.cfg.tracking.min_tracked_points // 2)
        if lost:
            self._state = TrackState.LOST
            self._frame_states.append(self._state)
            # Lost before the map is established -> hard reset (ref:
            # Tracking.cc:470-478 "Track lost soon after initialisation,
            # reseting..." -> Reset :1533): with <=5 keyframes there is
            # nothing worth relocalizing against, and a mono map this
            # young is usually a bad bootstrap.
            if self._kf_cursor_est <= 5:
                self.reset()
            return
        self._state = TrackState.OK
        # Host bookkeeping only: _ref_kf_dev stays the device-threaded value
        # from the LATEST dispatch (overwriting it here would feed the next
        # dispatch a pipeline_depth-stale reference keyframe).
        self.ref_kf = int(s[3])
        if self._need_new_keyframe(cur, n_local, int(s[4]), int(s[5]), fid=fid):
            self._create_keyframe(cur, timestamp, n_local, fid=fid)
        self._frame_states.append(self._state)
        self.stats.inliers_history.append(n_local)

    # ------------------------------------------------------------------
    def _track(self, cur: frame_mod.FrameData, timestamp: float):
        if self.state == TrackState.NOT_INITIALIZED:
            # Every init path ends in _finish_frame, which owns the single
            # frame_id increment (no double counting).
            if self.sensor == "mono":
                self._initialize_mono(cur, timestamp)
            else:
                self._initialize(cur, timestamp)
            return self.current_pose()

        if self.state == TrackState.LOST:
            if self._kf_cursor_est <= 5:
                # Hard reset instead of hopeless relocalization against a
                # map that never got established (Tracking.cc:470-478).
                self.reset()
                return self._track(cur, timestamp)
            if self._try_relocalize(cur, timestamp):
                return self.current_pose()
            if self.loop_closer is not None:
                # Relocalization is the only way back (Tracking.cc:414-417).
                self._finish_frame(cur, timestamp, lost=True)
                return self.current_pose()
            # No keyframe database attached: fall through and attempt
            # motion-model re-acquisition from the last known pose.

        # Fold in a finished background global BA, if any (the reference's
        # Tracking waits on mMutexMapUpdate while LoopClosing writes;
        # here the merge is one explicit program between frames).
        if self.loop_closer is not None:
            m2 = self.loop_closer.try_merge_gba(self.map)
            if m2 is not self.map:
                self.map_epoch += 1
                self.map = m2

        # 1. Motion-model tracking (fallback: reference keyframe).
        T_pred = se3.compose(self.velocity, self.last_frame.Tcw)
        Tcw, mp_idx, n_inl = track_ops.track_motion_model(
            self.cam, self.map.mp.pos, self.last_frame, cur, T_pred,
            self.scales, radius=self.cfg.matcher.search_radius_motion,
        )
        n_inl = int(n_inl)
        if n_inl < self.cfg.tracking.min_inliers_motion:
            Tcw, mp_idx, n_inl = track_ops.track_reference_kf(
                self.cam, self.map, self.ref_kf, cur, self.last_frame.Tcw
            )
            n_inl = int(n_inl)
        if n_inl < self.cfg.tracking.min_inliers_motion:
            self.state = TrackState.LOST
            # Keep last pose; relocalization handled by place recognition
            # (place/ + reloc path) once the KF database is wired in.
            self._finish_frame(cur._replace(Tcw=Tcw, mp_idx=mp_idx), timestamp, lost=True)
            return self.current_pose()

        # 2. Local-map tracking.
        res = track_ops.track_local_map(
            self.cam, self.map, cur, Tcw, mp_idx, self.cfg
        )
        n_local = int(res.n_inliers)
        cur = cur._replace(Tcw=res.Tcw, mp_idx=res.mp_idx)
        self.ref_kf = int(res.ref_kf)
        self._ref_kf_dev = jnp.int32(self.ref_kf)
        self.map = track_ops.update_tracking_stats(
            self.map, res.visible_rows, res.visible_mask, res.found_rows_mask
        )

        if n_local < self.cfg.tracking.min_tracked_points // 2:
            self.state = TrackState.LOST
            self._finish_frame(cur, timestamp, lost=True)
            return self.current_pose()
        self.state = TrackState.OK

        # 3. Keyframe policy + mapping step.
        close = (cur.depth > 0.01) & (
            cur.depth < self.cfg.tracking.th_depth * self.cam.baseline
        ) & cur.fvalid
        n_close_tracked = int(jnp.sum(close & (cur.mp_idx >= 0)))
        n_close_spawnable = int(jnp.sum(close & (cur.mp_idx < 0)))
        if self._need_new_keyframe(cur, n_local, n_close_tracked, n_close_spawnable):
            self._create_keyframe(cur, timestamp, n_local)

        self._finish_frame(cur, timestamp)
        self.stats.inliers_history.append(n_local)
        return self.current_pose()

    # ------------------------------------------------------------------
    def _initialize(self, cur: frame_mod.FrameData, timestamp: float) -> bool:
        """StereoInitialization (ref: Tracking.cc:509): first frame with
        enough depth features seeds the map at the origin."""
        n_depth = int(jnp.sum((cur.depth > 0) & cur.fvalid))
        if n_depth < 100:
            self._finish_frame(cur, timestamp, lost=True)
            return False
        cur = cur._replace(Tcw=jnp.eye(4))
        self.map, kf_row, mp_idx = track_ops.insert_keyframe_with_points(
            self.cam, self.map, cur, self.frame_id, timestamp,
            self.cfg, client=self.client,
        )
        cur = cur._replace(mp_idx=mp_idx)
        self.ref_kf = int(kf_row)
        self._ref_kf_dev = jnp.int32(self.ref_kf)
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id
        self._finish_frame(cur, timestamp)
        self.stats.n_keyframes += 1
        self._kf_cursor_est += 1
        return True

    def _initialize_mono(self, cur: frame_mod.FrameData, timestamp: float):
        """MonocularInitialization + CreateInitialMapMonocular (ref:
        Tracking.cc:569, :643): hold a reference frame, match area-window,
        run the two-view H/F bootstrap (solvers/initializer.py), scale the
        map to unit median depth, seed two keyframes + landmarks."""
        from ..solvers import initializer as init_mod

        n_feat = int(jnp.sum(cur.fvalid))
        if self._init_ref is None or n_feat < 100:
            self._init_ref = cur if n_feat >= 100 else None
            self._finish_frame(cur, timestamp, lost=True)
            return False
        ref = self._init_ref
        res = matcher.search_for_initialization(
            ref.xy, ref.desc, ref.angle, ref.fvalid,
            cur.xy, cur.desc, cur.angle, cur.fvalid,
            window=100.0, max_dist=self.cfg.matcher.th_low, ratio=0.9,
        )
        has = res.idx >= 0
        if int(jnp.sum(has)) < 100:  # Tracking.cc:607 requires >= 100
            self._init_ref = cur
            self._finish_frame(cur, timestamp, lost=True)
            return False
        xy2 = cur.xy[jnp.clip(res.idx, 0)]
        self._reloc_key, k = jax.random.split(self._reloc_key)
        two = init_mod.initialize_two_view(
            self.cam, ref.xy, xy2, has, k,
            min_triangulated=50,
        )
        if not bool(two.ok):
            self._finish_frame(cur, timestamp, lost=True)
            return False

        # Scale to unit median depth (CreateInitialMapMonocular,
        # Tracking.cc:714 invMedianDepth).
        good = two.good
        z = jnp.where(good, two.X[:, 2], jnp.nan)
        med = jnp.nanmedian(z)
        inv_med = 1.0 / jnp.maximum(med, 1e-6)
        X = two.X * inv_med
        T2 = jnp.eye(4).at[:3, :3].set(two.R).at[:3, 3].set(two.t * inv_med)

        # Landmarks (anchored at KF0 = the reference frame at identity).
        F = ref.xy.shape[0]
        dist = jnp.linalg.norm(X, axis=-1)
        scales = jnp.asarray(self.cfg.orb.scales(), jnp.float32)
        max_dist = dist * scales[ref.octave]
        min_dist = max_dist / (self.cfg.orb.scale_factor ** (self.cfg.orb.n_levels - 1))
        normal = X / jnp.maximum(dist[:, None], 1e-9)
        self.map, rows = ms.add_map_points(
            self.map, X, ref.desc, normal, min_dist, max_dist,
            ref_kf=0, create=good, client=self.client,
        )
        mp_ref = jnp.where(good, rows, ms.NO_MP)
        # Scatter bindings onto the matched cur features; non-good lanes go
        # to an out-of-range index and are dropped, so a valid binding on
        # cur feature 0 can't be clobbered by sentinel writes.
        mp_cur = jnp.full(F, ms.NO_MP, jnp.int32)
        f2 = jnp.where(good, jnp.clip(res.idx, 0), F)
        mp_cur = mp_cur.at[f2].set(rows, mode="drop")
        ref = ref._replace(Tcw=jnp.eye(4), mp_idx=mp_ref)
        cur = cur._replace(Tcw=T2, mp_idx=mp_cur)
        self.map, kf0 = ms.insert_keyframe(
            self.map, ref.Tcw, ref.xy, ref.octave, ref.angle, ref.desc,
            ref.uright, ref.depth, ref.fvalid, mp_ref,
            frame_id=self.frame_id - 1, timestamp=timestamp,
            client=self.client,
        )
        self.map, kf1 = ms.insert_keyframe(
            self.map, cur.Tcw, cur.xy, cur.octave, cur.angle, cur.desc,
            cur.uright, cur.depth, cur.fvalid, mp_cur,
            frame_id=self.frame_id, timestamp=timestamp,
            client=self.client,
        )
        # Two-view bundle adjustment over the fresh map (Tracking.cc:689).
        self.map = local_mapping.local_ba(self.cam, self.map, kf1, self.cfg)
        self.ref_kf = int(kf1)
        self._ref_kf_dev = jnp.int32(self.ref_kf)
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id
        self.ref_obs = int(jnp.sum(good))
        self.stats.n_keyframes += 2
        self._kf_cursor_est += 2
        self._init_ref = None
        self._finish_frame(cur, timestamp)
        return True

    def _try_relocalize(self, cur: frame_mod.FrameData, timestamp: float) -> bool:
        """Relocalization (Tracking.cc:1368) via the loop closer's keyframe
        database; consolidates with a local-map tracking pass."""
        if self.loop_closer is None:
            return False
        from . import reloc as reloc_mod

        self._reloc_key, k = jax.random.split(self._reloc_key)
        res = reloc_mod.relocalize(
            self.cam, self.map, self.loop_closer.db, self.loop_closer.voc,
            cur, k, self.cfg,
        )
        if res is None:
            return False
        out = track_ops.track_local_map(
            self.cam, self.map, cur, res.Tcw, res.mp_idx, self.cfg
        )
        if int(out.n_inliers) < self.cfg.tracking.min_tracked_points:
            return False
        cur = cur._replace(Tcw=out.Tcw, mp_idx=out.mp_idx)
        self.ref_kf = int(out.ref_kf)
        self._ref_kf_dev = jnp.int32(self.ref_kf)
        self.state = TrackState.OK
        self.velocity = jnp.eye(4)
        self.stats.n_relocalizations += 1
        self._finish_frame(cur, timestamp, lost=True)  # no velocity update
        return True

    def _need_new_keyframe(
        self, cur, n_tracked: int,
        n_close_tracked: int = 1 << 30, n_close_spawnable: int = 0,
        fid: Optional[int] = None,
    ) -> bool:
        """NeedNewKeyFrame (ref: Tracking.cc:995): max-frame gap, the
        tracked count fell below thRefRatio of what the last keyframe saw,
        or — the stereo/RGB-D driver — tracked CLOSE points thinned out
        while enough close features are available to spawn
        (bNeedToInsertClose, Tracking.cc:1036-1044: <100 tracked close &&
        >70 spawnable close). The ratio baseline is the tracked count AT
        keyframe creation (a cheap, honest stand-in for the reference's
        nRefMatches-with-minObs — raw per-KF feature counts include every
        freshly spawned point and would trigger a keyframe every frame)."""
        cfgt = self.cfg.tracking
        if fid is None:
            fid = self.frame_id
        frames_since_kf = fid - self.last_kf_frame_id
        if frames_since_kf < cfgt.min_frames_between_kf + 1:
            return False
        if frames_since_kf >= cfgt.max_frames_between_kf:
            return True
        if n_tracked < 50:
            return True
        need_close = n_close_tracked < 100 and n_close_spawnable > 70
        if need_close:
            return True
        ratio = (
            cfgt.kf_ref_ratio_mono if self.sensor == "mono"
            else cfgt.kf_ref_ratio_stereo
        )
        if n_tracked < ratio * max(self.ref_obs, 1) and n_tracked > 15:
            return True
        return False

    def _create_keyframe(self, cur, timestamp: float, n_tracked: int = 0,
                         fid: Optional[int] = None):
        if fid is None:
            fid = self.frame_id
        # Capacity gate (SURVEY.md §5.7): the keyframe cursor is append-only,
        # so a full table means no more keyframes — tracking continues
        # against the existing map instead of silently corrupting row N-1
        # (insert_keyframe drops OOB writes as the device-side backstop).
        # _kf_cursor_est is an exact host mirror of the device cursor
        # (inserts here/init, resync on compaction, collab downlink bumps
        # it) so neither this gate nor the new reference row needs a
        # blocking device sync in the middle of the pipelined frame loop.
        kf_row = self._kf_cursor_est
        if kf_row >= self.cfg.capacity.max_keyframes:
            if not getattr(self, "_warned_kf_full", False):
                self._warned_kf_full = True
                import sys
                print("[tracking] keyframe capacity reached "
                      f"({self.cfg.capacity.max_keyframes}); no further "
                      "keyframes will be created", file=sys.stderr)
            return
        self.ref_obs = max(n_tracked, 100)
        self.map, kf_row_dev, mp_idx = track_ops.insert_keyframe_with_points(
            self.cam, self.map, cur, fid, timestamp,
            self.cfg, client=self.client,
        )
        cur = cur._replace(mp_idx=mp_idx)
        self.last_kf_frame_id = fid
        self.ref_kf = kf_row
        self._ref_kf_dev = kf_row_dev.astype(jnp.int32)  # no host sync
        self.stats.n_keyframes += 1
        self._kf_cursor_est += 1
        if self.mapping_queue_enabled:
            self._enqueue_mapping_stages(kf_row)
            if self.sensor == "mono":
                # Mono drains the mapping pipeline EAGERLY at every
                # keyframe: triangulation is the only landmark source
                # (LocalMapping.cc:190) and the amortized one-stage-per-
                # frame drain lets stages from several keyframes
                # interleave — fresh two-observation landmarks then meet a
                # later keyframe's cull pass before fuse binds them, the
                # map thins (observed 370 -> 330 pts while KF cadence
                # doubled), the KF policy fires harder, and tracking
                # spirals LOST inside half an orbit. The reference's
                # mapping thread equally serializes full per-KF processing
                # (LocalMapping::Run). Stereo/RGB-D keep the amortized
                # drain: their landmarks spawn from per-frame depth at
                # insertion, so stage freshness is not tracking-critical.
                while self._stage_q:
                    self._run_stage()

    def _enqueue_mapping_stages(self, kf_row: int):
        """Queue the per-keyframe LocalMapping pipeline (ref:
        LocalMapping.cc:44) as individual device programs, drained one per
        frame by _dispatch_fused (or all at once by flush) — the
        equivalent of the reference's mapping THREAD: tracking frames never
        pay the whole insert+fuse+cull+BA chain inline. Fusion + local BA
        run per keyframe; the full-map maintenance passes alternate
        keyframes (whole-map reductions whose freshness is not
        frame-critical)."""
        q = self._stage_q
        nk = self.stats.n_keyframes
        if self.sensor == "mono":
            # Mono landmarks only come from inter-keyframe triangulation
            # (CreateNewMapPoints, LocalMapping.cc:190); stereo/RGB-D spawn
            # from per-frame depth at keyframe creation instead.
            q.append(lambda: setattr(
                self, "map",
                triangulation.create_new_points(
                    self.cam, self.map, kf_row, self.cfg)))
        q.append(lambda: setattr(
            self, "map",
            local_mapping.fuse_into_kf(self.cam, self.map, kf_row, self.cfg)))
        if nk % 2 == 0:
            q.append(lambda: setattr(
                self, "map",
                local_mapping.cull_map_points(
                    self.map, kf_row, self.cfg,
                    mono=self.sensor == "mono")))
            q.append(lambda: setattr(
                self, "map",
                local_mapping.refresh_point_geometry(
                    self.map, kf_row, self.cfg)))
        if nk >= 3:
            # Local BA split across two frames: robust phase, then plain
            # polish + writeback (see local_mapping.local_ba_build — no
            # single frame pays the whole LM loop). State crosses stages
            # through `st`; between them only tracking runs, which never
            # touches the quantities the writeback writes.
            st: dict = {}
            q.append(lambda: self._stage_local_ba_build(kf_row, st))
            q.append(lambda: self._stage_local_ba_a(st))
            q.append(lambda: self._stage_local_ba_b(st))
        if nk % 3 == 0 and nk > 5:
            q.append(lambda: self._stage_cull_keyframes(kf_row))
        if nk % 6 == 0 and nk > 5:
            # Episodic full-map hygiene: detach stragglers the bounded
            # cull/fuse windows may have missed (see local_mapping notes).
            q.append(lambda: setattr(
                self, "map", local_mapping.sweep_detached(self.map)))
        if self.loop_closer is not None:
            q.append(lambda: self._stage_loop_closing(kf_row))

    def _run_stage(self):
        self._stage_q.popleft()()

    def _stage_loop_closing(self, kf_row: int):
        """Loop-closing stage; bumps the map epoch when a correction or a
        GBA merge moved keyframe poses (aborts in-flight split local BAs)."""
        lc = self.loop_closer
        loops0 = lc.stats.n_loops_closed
        merges0 = getattr(lc.gba_runner, "runs_finished", 0) \
            if lc.gba_runner is not None else 0
        self.map = lc.process_keyframe(self.map, kf_row)
        merges1 = getattr(lc.gba_runner, "runs_finished", 0) \
            if lc.gba_runner is not None else 0
        if lc.stats.n_loops_closed != loops0 or merges1 != merges0:
            self.map_epoch += 1

    def _stage_local_ba_build(self, kf_row: int, st: dict):
        """Local BA stage 0: window selection + problem build (a full
        observation-table scan — its own frame)."""
        st["epoch"] = self.map_epoch
        st["sel"], st["prob"] = local_mapping.local_ba_build(
            self.map, kf_row, self.cfg)

    def _stage_local_ba_a(self, st: dict):
        """Local BA stage 1: robust LM phase."""
        from ..optim import ba_dense

        if st["epoch"] != self.map_epoch:
            st["res"] = None  # aborted: poses moved under the window
            return
        n1 = max(self.cfg.mapping.local_ba_iters - 2, 1)
        st["res"] = ba_dense.optimize(
            self.cam, st["prob"], n_iters=n1,
            cg_iters=self.cfg.mapping.local_ba_cg_iters, huber_iters=3)

    def _stage_local_ba_b(self, st: dict):
        """Local BA stage 2: plain polish on the reclassified inliers +
        writeback into the (one-frame-newer) map. Aborts (mbAbortBA) if a
        loop correction / GBA merge / compaction moved poses since the
        window was built — writing the stale linearization back would
        undo that correction for the window keyframes."""
        from ..optim import ba_dense

        if st.get("res") is None or st["epoch"] != self.map_epoch:
            return
        sel, prob, res = st["sel"], st["prob"], st["res"]
        prob2 = prob._replace(
            Tcw=res.Tcw, X=res.X, obs_active=prob.obs_active & res.inlier)
        res2 = ba_dense.optimize(
            self.cam, prob2, n_iters=2,
            cg_iters=self.cfg.mapping.local_ba_cg_iters, huber_iters=0)
        self.map = local_mapping.local_ba_writeback(
            self.map, sel.kf_rows, sel.kf_free, sel.kf_ok,
            sel.mp_rows, sel.mp_ok,
            res2.Tcw, res2.X, res2.inlier, prob.obs_active,
        )

    def _stage_cull_keyframes(self, kf_row: int):
        """Redundant-keyframe culling (KeyFrameCulling, LocalMapping.cc:590)."""
        self.map, kill = local_mapping.cull_keyframes(self.map, kf_row, self.cfg)
        if self.loop_closer is not None:
            self.loop_closer.db = self.loop_closer.db.remove(kill)

    def _mapping_step(self, kf_row: int):
        """Synchronous form of the per-keyframe pipeline (profiling tools +
        tests drive it directly)."""
        self._enqueue_mapping_stages(kf_row)
        while self._stage_q:
            self._run_stage()

    def _compact_map(self):
        """Repack the map (ms.compact) and remap every host row reference:
        reference keyframe, local window, current frame bindings, and the
        loop closer's row-aligned state. Runs with the frame pipeline
        flushed (callers flush first)."""
        if int(self.map.n_kf) < int(0.5 * self.cfg.capacity.max_keyframes):
            # Estimate drifted (e.g. nothing was culled); resync and skip.
            self._kf_cursor_est = int(self.map.n_kf)
            return
        res = ms.compact(self.map)
        self.map = res.m
        kmap = np.asarray(res.kf_old2new)
        pmap_dev = res.mp_old2new
        new_ref = int(kmap[self.ref_kf]) if self.ref_kf >= 0 else -1
        self.ref_kf = new_ref if new_ref >= 0 else 0
        self._ref_kf_dev = jnp.int32(self.ref_kf)
        lr = res.kf_old2new[jnp.clip(self._local_rows, 0)]
        self._local_ok = self._local_ok & (lr >= 0)
        self._local_rows = jnp.clip(lr, 0)
        if self.last_frame is not None:
            idx = self.last_frame.mp_idx
            idx = jnp.where(idx >= 0, pmap_dev[jnp.clip(idx, 0)], ms.NO_MP)
            self.last_frame = self.last_frame._replace(mp_idx=idx)
        if self.loop_closer is not None:
            self.loop_closer.remap_rows(res)
        for cb in self.on_compact:
            cb(res)
        self.map_epoch += 1  # rows renumbered
        self.stats.n_compactions += 1
        self._kf_cursor_est = int(self.map.n_kf)
        if self._kf_cursor_est >= int(0.85 * self.cfg.capacity.max_keyframes):
            # Map genuinely full (culling freed nothing): back off so a
            # full map costs one repack per cooldown, not one per frame.
            self._compact_cooldown = self.frame_id + 60

    def reset(self):
        """Hard system reset — `Tracking::Reset` (ref: Tracking.cc:1533):
        clear the map, the keyframe database / loop-closer state and the id
        counters, drop in-flight work, and return to NOT_INITIALIZED so the
        next frame re-bootstraps. Subscribers with map-addressed state (the
        collab ClientCache) register on_reset callbacks; entities already
        pushed to a server stay there as a dead sub-map — the reference
        behaves the same (its Reset does not retract served keyframes)."""
        self._pending.clear()
        self._stage_q.clear()
        self._pair_buf.clear()
        self.map = ms.empty(self.cfg.capacity)
        self._state = TrackState.NOT_INITIALIZED
        self.last_frame = None
        self.velocity = jnp.eye(4)
        self.last_kf_frame_id = 0
        self.ref_kf = 0
        self._ref_kf_dev = jnp.int32(0)
        self.ref_obs = 0
        self._init_ref = None
        self._kf_cursor_est = 0
        self._compact_cooldown = 0
        self.map_epoch += 1
        self.stats.n_resets = getattr(self.stats, "n_resets", 0) + 1
        if self.loop_closer is not None:
            self.loop_closer.reset()
        for cb in getattr(self, "on_reset", []):
            cb()

    def _finish_frame(self, cur, timestamp: float, lost: bool = False,
                      Tcw_np: Optional[np.ndarray] = None):
        """Bookkeeping tail of every frame. `lost=True` skips the velocity
        update (the fused path also uses it after setting velocity itself,
        from the device program's output). `Tcw_np` avoids a second
        device->host transfer when the pose already came back in the fused
        summary vector."""
        if self.last_frame is not None and not lost:
            self.velocity = se3.compose(cur.Tcw, se3.inverse(self.last_frame.Tcw))
        self.last_frame = cur
        self._traj.append(
            (timestamp, np.asarray(cur.Tcw) if Tcw_np is None else Tcw_np)
        )
        self._frame_states.append(self._state)
        self.frame_id += 1
        self.stats.n_frames += 1

    # ------------------------------------------------------------------
    def current_pose(self) -> np.ndarray:
        """Latest RETIRED pose (may lag the in-flight pipelined frame by
        one; use `flush()` + `trajectory` for the complete history)."""
        return self._traj[-1][1] if self._traj else np.eye(4)

    def trajectory_kitti(self) -> np.ndarray:
        """[T, 3, 4] Twc rows — the SaveTrajectoryKITTI format
        (ref: System.cc:350)."""
        out = []
        for _, Tcw in self.trajectory:
            Twc = np.asarray(se3.inverse(jnp.asarray(Tcw)))
            out.append(Twc[:3, :4])
        return np.stack(out) if out else np.zeros((0, 3, 4))
