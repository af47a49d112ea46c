"""End-to-end single-client pipeline tests on the synthetic planar world —
the hermetic equivalent of the reference's KITTI replay validation
(SURVEY.md §4, §7.2 step 5: minimum end-to-end slice)."""

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.config import (
    CapacityConfig, MappingConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from corbslam.frontend.tracking import StereoTracker, TrackState
from corbslam.geometry import camera, se3
from corbslam.io import synthetic, trajectory
from corbslam.ops import stereo

# Small camera + config so CPU tests stay fast.
CAM = camera.Intrinsics.create(
    fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5,
    width=320, height=240,
)

CFG = SlamConfig(
    orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
    tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
    mapping=MappingConfig(local_ba_window=8, local_ba_iters=6),
    capacity=CapacityConfig(
        max_keyframes=64, max_map_points=8192, max_features=512,
        local_window_kfs=8, local_window_mps=2048,
    ),
)


@pytest.fixture(scope="module")
def world():
    return synthetic.PlanarWorld(CAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)


def gt_trajectory(n=20, dx=0.12, dyaw=0.004, tilt_pitch=0.35):
    """Sideways+forward sweep keeping the plane in view.

    The camera is pitched by `tilt_pitch` so scene depth VARIES across the
    image: a fronto-parallel single plane leaves the x-translation/yaw error
    mode nearly unobservable (t ~ d*theta ambiguity) and any tracker drifts
    along it — a property of the scene, not the tracker.
    """
    tilt = se3.exp(jnp.asarray([0, 0, 0, tilt_pitch, 0, 0], jnp.float32))
    poses = []
    for i in range(n):
        xi = jnp.asarray([-(i * dx), 0.0, -(i * 0.03), 0.0, i * dyaw, 0.0], jnp.float32)
        poses.append(se3.compose(tilt, se3.exp(xi)))  # Tcw
    return poses


class TestStereoMatcherE2E:
    def test_disparity_matches_ground_truth(self, world):
        from corbslam.frontend import frame as frame_mod

        Tcw = se3.identity()
        img_l, img_r = world.render_stereo(Tcw)
        f = frame_mod.build_frame_stereo(img_l, img_r, CAM, CFG.orb)
        ok = np.asarray((f.depth > 0) & f.fvalid)
        assert ok.sum() > 100
        depth_gt = np.asarray(world.depth(Tcw))
        xy = np.asarray(f.xy)[ok]
        d_est = np.asarray(f.depth)[ok]
        d_gt = depth_gt[
            np.clip(np.round(xy[:, 1]).astype(int), 0, 239),
            np.clip(np.round(xy[:, 0]).astype(int), 0, 319),
        ]
        rel_err = np.abs(d_est - d_gt) / d_gt
        assert np.median(rel_err) < 0.05
        assert (rel_err < 0.1).mean() > 0.7


class TestTrackingE2E:
    @pytest.fixture(scope="class")
    def run(self, world):
        tracker = StereoTracker(CAM, CFG)
        gt = gt_trajectory(16)
        for i, Tcw in enumerate(gt):
            img_l, img_r = world.render_stereo(Tcw)
            tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
        return tracker, gt

    def test_stays_tracked(self, run):
        tracker, gt = run
        assert tracker.state == TrackState.OK
        assert tracker.stats.n_frames == len(gt)
        assert tracker.stats.n_keyframes >= 2

    def test_ate(self, run):
        tracker, gt = run
        est = [np.asarray(se3.inverse(jnp.asarray(T))) for _, T in tracker.trajectory]
        gtw = [np.asarray(se3.inverse(T)) for T in gt]
        # align=True removes the world-frame gauge (the tracker's world is
        # its first camera frame; GT's world is the plane frame).
        rmse = trajectory.ate_rmse(np.asarray(est), np.asarray(gtw), align=True)
        # Scene scale: 10 m plane, ~1.9 m travel, 320px camera with 512
        # features. ~2-3% drift expected at this scale.
        assert rmse < 0.06, rmse

    def test_map_health(self, run):
        tracker, _ = run
        m = tracker.map
        assert int(m.n_kf) == tracker.stats.n_keyframes
        n_valid_mp = int(jnp.sum(m.mp.valid))
        assert n_valid_mp > 200
        # Points lie near the plane z=10 after mapping the tracker frame
        # (its world = first camera pose) back to the GT world frame.
        pos = np.asarray(m.mp.pos)[np.asarray(m.mp.valid)]
        tilt_inv = np.asarray(se3.inverse(gt_trajectory(1)[0]))
        pos_w = pos @ tilt_inv[:3, :3].T + tilt_inv[:3, 3]
        assert np.median(np.abs(pos_w[:, 2] - 10.0)) < 0.5

    def test_trajectory_export(self, run, tmp_path):
        tracker, _ = run
        path = tmp_path / "traj.txt"
        trajectory.save_kitti(str(path), tracker.trajectory_kitti())
        rows = np.loadtxt(path)
        assert rows.shape == (tracker.stats.n_frames, 12)


class TestRgbdE2E:
    """RGB-D pipeline end to end (VERDICT r3 weak #7: process_rgbd /
    track_frame_rgbd / compute_stereo_from_rgbd had zero coverage, and the
    r2 advisor found a real bias bug in exactly this path). Same world as
    the stereo run, but the tracker ingests (gray, depth-map) frames —
    ComputeStereoFromRGBD semantics (ref: Frame.cc:647)."""

    @pytest.fixture(scope="class")
    def run(self, world):
        tracker = StereoTracker(CAM, CFG)
        gt = gt_trajectory(16)
        for i, Tcw in enumerate(gt):
            img, _ = world.render_stereo(Tcw)
            depth = world.depth(Tcw)
            tracker.process_rgbd(img, depth, timestamp=i * 0.1)
        return tracker, gt

    def test_stays_tracked(self, run):
        tracker, gt = run
        assert tracker.state == TrackState.OK
        assert tracker.stats.n_frames == len(gt)
        assert tracker.stats.n_keyframes >= 2

    def test_ate(self, run):
        tracker, gt = run
        est = [np.asarray(se3.inverse(jnp.asarray(T)))
               for _, T in tracker.trajectory]
        gtw = [np.asarray(se3.inverse(T)) for T in gt]
        rmse = trajectory.ate_rmse(np.asarray(est), np.asarray(gtw),
                                   align=True)
        # Perfect depth input -> at least stereo-grade accuracy.
        assert rmse < 0.06, rmse

    def test_depth_bindings_consistent(self, run):
        """Spawned landmarks sit at their RGB-D depth (guards the uright /
        depth bias class of bug the r2 advisor found)."""
        tracker, gt = run
        tracker.flush()
        m = tracker.map
        pos = np.asarray(m.mp.pos)[np.asarray(m.mp.valid)]
        tilt_inv = np.asarray(se3.inverse(gt_trajectory(1)[0]))
        pos_w = pos @ tilt_inv[:3, :3].T + tilt_inv[:3, 3]
        assert np.median(np.abs(pos_w[:, 2] - 10.0)) < 0.5


class TestMonocularE2E:
    """Monocular pipeline: two-view bootstrap + triangulation-based mapping
    (scale-free — ATE evaluated with similarity alignment)."""

    @pytest.fixture(scope="class")
    def run(self, world):
        tracker = StereoTracker(CAM, CFG)
        gt = gt_trajectory(16, dx=0.15)
        for i, Tcw in enumerate(gt):
            img, _ = world.render_stereo(Tcw)
            tracker.process_mono(img, timestamp=i * 0.1)
        return tracker, gt

    def test_initializes_and_tracks(self, run):
        tracker, gt = run
        assert tracker.state == TrackState.OK
        assert tracker.stats.n_keyframes >= 2
        n_valid_mp = int(jnp.sum(tracker.map.mp.valid))
        assert n_valid_mp > 100, n_valid_mp

    def test_ate_similarity_aligned(self, run):
        tracker, gt = run
        from corbslam.geometry import se3 as se3m
        # Only frames tracked OK count (mono needs several frames of
        # parallax before the two-view bootstrap fires; pre-init poses are
        # placeholders).
        tracked = [i for i, st in enumerate(tracker.frame_states)
                   if st == TrackState.OK]
        assert len(tracked) >= 8
        est = [np.asarray(se3m.inverse(jnp.asarray(tracker.trajectory[i][1])))
               for i in tracked]
        gtw = [np.asarray(se3m.inverse(gt[i])) for i in tracked]
        rmse = trajectory.ate_rmse(
            np.asarray(est), np.asarray(gtw), align=True, with_scale=True
        )
        assert rmse < 0.15, rmse


class TestStageQueueDiscipline:
    """Regression tests for the r4 deferred-stage backlog (VERDICT r4 #1):
    the 3-stage local BA raised stage production per keyframe above the
    per-frame consumption, the queue grew unboundedly, and the WHOLE
    mapping+loop pipeline deferred to shutdown flush — where loop closure
    then fired on a map state far from the one it was detected in."""

    def test_stage_queue_stays_bounded_under_kf_pressure(self, world):
        cfg = SlamConfig(
            orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
            tracking=TrackingConfig(
                th_depth=40.0, min_frames_between_kf=0,
                max_frames_between_kf=1,  # force a keyframe every frame
            ),
            mapping=MappingConfig(local_ba_window=8, local_ba_iters=6),
            capacity=CapacityConfig(
                max_keyframes=64, max_map_points=8192, max_features=512,
                local_window_kfs=8, local_window_mps=2048,
            ),
        )
        tracker = StereoTracker(CAM, cfg)
        gt = gt_trajectory(14)
        for i, Tcw in enumerate(gt):
            img_l, img_r = world.render_stereo(Tcw)
            tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
            # Bound: the post-frame drain target (4) plus at most one
            # keyframe's worth of stages enqueued by the in-frame retire.
            assert len(tracker._stage_q) <= 12, (i, len(tracker._stage_q))
        assert tracker.stats.n_keyframes >= 10

    def test_stale_local_ba_writeback_aborts_on_epoch_bump(self, world):
        """A split local BA whose window was built before a loop
        correction / GBA merge / compaction must NOT write back (the
        reference's mbAbortBA, LocalMapping.cc:79)."""
        tracker = StereoTracker(CAM, CFG)
        gt = gt_trajectory(14)
        for i, Tcw in enumerate(gt):
            img_l, img_r = world.render_stereo(Tcw)
            tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
        tracker.flush()
        kf_row = tracker.ref_kf
        st = {}
        tracker._stage_local_ba_build(kf_row, st)
        tracker.map_epoch += 1  # poses moved under the window
        before = tracker.map
        tracker._stage_local_ba_a(st)
        assert st["res"] is None
        tracker._stage_local_ba_b(st)
        assert tracker.map is before  # no writeback happened

    def test_fresh_local_ba_writeback_commits(self, world):
        tracker = StereoTracker(CAM, CFG)
        gt = gt_trajectory(14)
        for i, Tcw in enumerate(gt):
            img_l, img_r = world.render_stereo(Tcw)
            tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
        tracker.flush()
        kf_row = tracker.ref_kf
        st = {}
        tracker._stage_local_ba_build(kf_row, st)
        before = tracker.map
        tracker._stage_local_ba_a(st)
        assert st["res"] is not None
        tracker._stage_local_ba_b(st)
        assert tracker.map is not before
        assert bool(jnp.isfinite(tracker.map.kf.Tcw).all())


class TestLostEarlyHardReset:
    """Lost-early hard reset (ref: Tracking.cc:470-478 -> Reset :1533):
    tracking lost while the map holds <=5 keyframes clears everything and
    re-bootstraps from the next good frame instead of relocalizing against
    a map that never got established."""

    def test_reset_and_recover(self, world):
        tracker = StereoTracker(CAM, CFG)
        gt = gt_trajectory(24)
        # 4 good frames -> initialized, a couple of keyframes.
        for i in range(4):
            img_l, img_r = world.render_stereo(gt[i])
            tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
        tracker.flush()
        assert tracker.state == TrackState.OK
        assert 1 <= tracker.stats.n_keyframes <= 5
        # Featureless frames kill tracking while the map is still tiny.
        blank = jnp.zeros((CAM.height, CAM.width), jnp.float32)
        for i in range(4, 8):
            tracker.process_stereo(blank, blank, timestamp=i * 0.1)
        tracker.flush()
        assert tracker.stats.n_resets >= 1
        assert int(tracker.map.n_kf) == 0 or tracker.state in (
            TrackState.NOT_INITIALIZED, TrackState.LOST)
        # Good frames again -> fresh bootstrap, tracking OK.
        for i in range(8, 16):
            img_l, img_r = world.render_stereo(gt[i])
            tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
        tracker.flush()
        assert tracker.state == TrackState.OK
        assert tracker.stats.n_keyframes >= 1
        assert bool(jnp.isfinite(tracker.map.kf.Tcw).all())


class TestTwoFramePerDispatch:
    """frames_per_dispatch=2 (track_ops.track_frame_stereo2): two frames
    chained in one program must reproduce the single-dispatch pipeline's
    tracking quality (the dispatch-halving mode, config.py
    TrackingConfig.frames_per_dispatch)."""

    def test_matches_single_dispatch_quality(self, world):
        import dataclasses
        cfg2 = CFG.replace(tracking=dataclasses.replace(
            CFG.tracking, frames_per_dispatch=2))
        gt = gt_trajectory(17)  # odd count exercises the flush tail
        results = {}
        for name, cfg in (("fpd1", CFG), ("fpd2", cfg2)):
            tracker = StereoTracker(CAM, cfg)
            for i, Tcw in enumerate(gt):
                img_l, img_r = world.render_stereo(Tcw)
                tracker.process_stereo(img_l, img_r, timestamp=i * 0.1)
            tracker.flush()
            assert tracker.state == TrackState.OK
            assert len(tracker.trajectory) == len(gt)
            est = [np.asarray(se3.inverse(jnp.asarray(T)))
                   for _, T in tracker.trajectory]
            gtw = [np.asarray(se3.inverse(T)) for T in gt]
            results[name] = trajectory.ate_rmse(
                np.asarray(est), np.asarray(gtw), align=True)
        assert results["fpd2"] < 0.06, results
        assert results["fpd2"] < results["fpd1"] * 2.0 + 0.01, results
