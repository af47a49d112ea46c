"""Top-level client facade.

Replaces `System` (ref: corbslam_client/src/System.cc: ctor builds Cache +
6 threads :79-92; TrackStereo :107 / TrackRGBD :146 / TrackMonocular :185;
Shutdown :239; SaveTrajectoryTUM :254 / SaveTrajectoryKITTI :350 /
SaveKeyFrameTrajectoryTUM :312; SaveMap/LoadMap :405 -> Cache.cc:301-318,
which boost-archives the pointer graph to a hardcoded 'savetest.txt').

Re-design: one object wiring the tracker (frontend/tracking.py), loop
closer (loop/), and collaboration cache (collab/) together; the reference's
thread pipeline becomes explicit step scheduling (sync cadence in frames,
driven from the ingest calls — deterministic by construction). Checkpoints
are the SoA map pytree dumped to one npz (no pointer graphs, no hardcoded
filenames), restorable mid-run.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .config import SlamConfig
from .frontend.tracking import StereoTracker, TrackState
from .geometry import camera as cam_mod
from .geometry import se3
from .io import trajectory as traj_mod
from .loop.loop_closing import LoopCloser
from .mapstate import mapstate as ms
from .place import vocab as vocab_mod


class CorbslamClient:
    """One SLAM client: tracking + local mapping + loop closing +
    (optionally) collaboration with a fusion server."""

    def __init__(
        self,
        cam: cam_mod.Intrinsics,
        cfg: SlamConfig,
        sensor: str = "stereo",
        client_id: int = 1,
        voc: Optional[vocab_mod.Vocabulary] = None,
        transport=None,
        enable_loop_closing: bool = True,
        run_gba: bool = True,
        metrics_path: Optional[str] = None,
    ):
        self.cam = cam
        self.cfg = cfg
        self.sensor = sensor
        self.client_id = client_id
        self.voc = voc
        self.loop_closer = None
        if enable_loop_closing and voc is not None:
            self.loop_closer = LoopCloser(
                cam, cfg, voc,
                fix_scale=(sensor != "mono"), run_gba=run_gba,
                seed=client_id,
            )
        self.tracker = StereoTracker(
            cam, cfg, client=client_id, loop_closer=self.loop_closer
        )
        self.cache = None
        if transport is not None:
            from .collab.client_cache import ClientCache

            self.cache = ClientCache(
                self.tracker, transport, client_id, cfg,
                loop_closer=self.loop_closer,
            )
            self.cache.start_async_uplink()
            # Compaction stays ENABLED under collaboration (the r3 gap):
            # the cache registers an on_compact callback that remaps its
            # gid<->row maps, uid tables, snapshots and cursors atomically
            # with the repack; own identity is uid-based so reclaimed row
            # numbers never collide with the server's entities.
        # Sync cadence in frames (the reference syncs on wall-clock: 6 s
        # uplink Cache.cc:370, 2 s downlink poll; at the 10 fps replay rate
        # that is 60 / 20 frames).
        self.uplink_every = 60
        self.downlink_every = 20
        self._metrics = open(metrics_path, "a") if metrics_path else None

    # ------------------------------------------------------------------
    # Ingest (System::TrackStereo / TrackRGBD / TrackMonocular)
    # ------------------------------------------------------------------

    def track_stereo(self, img_l, img_r, timestamp: float) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.tracker.process_stereo(img_l, img_r, timestamp)
        self._after_frame(t0, timestamp)
        return pose

    def track_rgbd(self, img, depth, timestamp: float) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.tracker.process_rgbd(img, depth, timestamp)
        self._after_frame(t0, timestamp)
        return pose

    def track_monocular(self, img, timestamp: float) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.tracker.process_mono(img, timestamp)
        self._after_frame(t0, timestamp)
        return pose

    def _after_frame(self, t0: float, timestamp: float):
        n = self.tracker.stats.n_frames
        if self.cache is not None:
            if n % self.downlink_every == 0:
                self.cache.downlink_step()
            if n % self.uplink_every == 0:
                # Async: snapshot + hand to the uplink worker (the
                # reference's runUpdateToServer thread, Cache.cc:322) —
                # tracking must not block on the server's fusion-busy ACK.
                self.cache.request_uplink()
        if self._metrics is not None:
            rec = {
                "t": timestamp,
                "frame": n,
                "state": self.tracker.state.name,
                "track_ms": round((time.perf_counter() - t0) * 1e3, 2),
                "n_kf": int(self.tracker.map.n_kf),
                "n_mp": int(jnp.sum(self.tracker.map.mp.valid)),
                "inliers": (
                    self.tracker.stats.inliers_history[-1]
                    if self.tracker.stats.inliers_history else 0
                ),
            }
            self._metrics.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------
    def shutdown(self):
        """Flush sync + stop background optimization (System::Shutdown)."""
        self.tracker.flush()  # retire the in-flight pipelined frame
        if self.cache is not None:
            self.cache.stop_async_uplink()  # drain worker, then final push
            # The final push must actually land: a single failed call here
            # (server busy in fusion/GBA for seconds) left clients with
            # kfs_pushed=0 while the server had already deduplicated their
            # retried entities (r4 SCALING artifacts' counter mismatch).
            # Retry with backoff until acked or the budget runs out.
            import time as _time
            for attempt in range(5):
                if self.cache.uplink_step():
                    break
                _time.sleep(0.5 * (attempt + 1))
            self.cache.downlink_step()
        if self.loop_closer is not None and self.loop_closer.gba_runner:
            self.loop_closer.gba_runner.wait()
            self.tracker.map = self.loop_closer.try_merge_gba(self.tracker.map)
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    # ------------------------------------------------------------------
    # Trajectory export (SaveTrajectory*, System.cc:254-403)
    # ------------------------------------------------------------------

    def save_trajectory_kitti(self, path: str):
        traj_mod.save_kitti(path, self.tracker.trajectory_kitti())

    def save_trajectory_tum(self, path: str):
        ts = [t for t, _ in self.tracker.trajectory]
        Twc = [
            np.asarray(se3.inverse(jnp.asarray(T)))
            for _, T in self.tracker.trajectory
        ]
        traj_mod.save_tum(path, ts, Twc, se3.quat_from_R)

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.tracker.map
        valid = np.asarray(m.kf.valid)
        rows = np.nonzero(valid)[0]
        ts = np.asarray(m.kf.timestamp)[rows]
        Twc = [np.asarray(se3.inverse(m.kf.Tcw[r])) for r in rows]
        traj_mod.save_tum(path, ts.tolist(), Twc, se3.quat_from_R)

    # ------------------------------------------------------------------
    # Checkpoint / resume (System::SaveMap/LoadMap done right)
    # ------------------------------------------------------------------

    def save_map(self, path: str):
        """Snapshot the whole map state to one npz (the SoA pytree IS the
        serialization format — SURVEY.md §5.4)."""
        m = self.tracker.map
        arrays = {f"kf_{k}": np.asarray(v) for k, v in m.kf._asdict().items()}
        arrays.update({f"mp_{k}": np.asarray(v) for k, v in m.mp._asdict().items()})
        arrays["n_kf"] = np.asarray(m.n_kf)
        arrays["n_mp"] = np.asarray(m.n_mp)
        if self.loop_closer is not None:
            arrays["db_bow"] = np.asarray(self.loop_closer.db.bow)
            arrays["db_valid"] = np.asarray(self.loop_closer.db.valid)
            arrays["voc_bits"] = np.asarray(self.voc.word_bits)
            arrays["voc_idf"] = np.asarray(self.voc.idf)
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str):
        data = np.load(path)
        kf = ms.KeyFrames(**{
            k: jnp.asarray(data[f"kf_{k}"]) for k in ms.KeyFrames._fields
        })
        mp = ms.MapPoints(**{
            k: jnp.asarray(data[f"mp_{k}"]) for k in ms.MapPoints._fields
        })
        self.tracker.map = ms.MapState(
            kf, mp, jnp.asarray(data["n_kf"]), jnp.asarray(data["n_mp"])
        )
        if self.loop_closer is not None and "db_bow" in data:
            from .place.database import BowDatabase

            self.loop_closer.db = BowDatabase(
                jnp.asarray(data["db_bow"]), jnp.asarray(data["db_valid"])
            )
        # Resume allocation after the loaded rows.
        self.tracker.ref_kf = max(int(self.tracker.map.n_kf) - 1, 0)
        self.tracker._ref_kf_dev = jnp.int32(self.tracker.ref_kf)
        self.tracker._kf_cursor_est = int(self.tracker.map.n_kf)
        self.tracker.state = TrackState.LOST  # relocalize into the loaded map
