"""E2E validation on the non-planar MultiPlaneWorld (room): 3-D structure,
photometric noise, and a closed-loop trajectory — the harder validation
surface VERDICT r1 asked for beyond the single textured plane (which is
degenerate for F-init and trivially texture-rich). Mirrors the reference's
manual loop-closure validation on KITTI 00 (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.config import (
    CapacityConfig, MappingConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from corbslam.frontend.tracking import StereoTracker, TrackState
from corbslam.geometry import camera, se3
from corbslam.io import synthetic, trajectory

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
    # Room with visible pixel noise (std 3/255 grey levels).
    return synthetic.MultiPlaneWorld.room(
        CAM, half=14.0, height=3.0, noise_std=3.0, seed=2)


class TestWorldGeometry:
    def test_depth_is_nonplanar(self, world):
        """Looking into a room corner: large depth spread + discontinuities
        (single-plane worlds have a smooth 1/z ramp only)."""
        Tcw = se3.exp(jnp.asarray([0, 0, 0, 0, 0.6, 0], jnp.float32))
        d = np.asarray(world.depth(Tcw))
        valid = d > 0
        assert valid.mean() > 0.95
        assert d[valid].max() / max(d[valid].min(), 1e-3) > 2.0
        # Depth-gradient kink at the room corner (depth is continuous
        # across a convex corner; its slope is not).
        row = d[120]
        dd = np.abs(np.diff(row, 2))
        assert dd.max() > 10.0 * max(np.median(dd), 1e-6)

    def test_noise_varies_per_frame(self, world):
        Tcw = se3.identity()
        a = np.asarray(world.render(Tcw, frame=0))
        b = np.asarray(world.render(Tcw, frame=1))
        assert np.abs(a - b).mean() > 1.0  # photometric noise present
        assert np.abs(a - b).mean() < 10.0  # ... but bounded

    def test_stereo_depth_recovered(self, world):
        from corbslam.frontend import frame as frame_mod

        Tcw = se3.identity()
        l, r = world.render_stereo(Tcw, frame=0)
        f = frame_mod.build_frame_stereo(l, r, CAM, CFG.orb)
        ok = np.asarray((f.depth > 0) & f.fvalid)
        assert ok.sum() > 80
        d_gt_map = np.asarray(world.depth(Tcw))
        xy = np.asarray(f.xy)[ok]
        d_est = np.asarray(f.depth)[ok]
        d_gt = d_gt_map[
            np.clip(np.round(xy[:, 1]).astype(int), 0, 239),
            np.clip(np.round(xy[:, 0]).astype(int), 0, 319),
        ]
        rel = np.abs(d_est - d_gt) / np.maximum(d_gt, 1e-3)
        assert np.median(rel) < 0.08


def arc_trajectory(n, radius=6.0, step=0.035):
    """Camera orbiting inside the room, looking outward: closed after
    2*pi/step frames."""
    poses = []
    for i in range(n):
        th = step * i
        # World position on a circle; camera yaw follows the tangent+out.
        Twc = se3.compose(
            se3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
            se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -radius])),
        )
        poses.append(se3.inverse(Twc))
    return poses


class TestTrackingOnStructuredWorld:
    @pytest.fixture(scope="class")
    def run(self, world):
        tracker = StereoTracker(CAM, CFG)
        gt = arc_trajectory(16)
        for i, Tcw in enumerate(gt):
            l, r = world.render_stereo(Tcw, frame=i)
            tracker.process_stereo(l, r, timestamp=i * 0.1)
        return tracker, gt

    def test_stays_tracked_under_noise(self, run):
        tracker, gt = run
        assert tracker.state == TrackState.OK
        assert tracker.stats.n_frames == len(gt)
        assert tracker.stats.n_keyframes >= 2

    def test_ate_on_structured_world(self, run):
        tracker, gt = run
        est = [np.asarray(se3.inverse(jnp.asarray(T)))
               for _, T in tracker.trajectory]
        gtw = [np.asarray(se3.inverse(T)) for T in gt]
        rmse = trajectory.ate_rmse(np.asarray(est), np.asarray(gtw), align=True)
        # ~3.3 m travel in a 14 m room under pixel noise.
        assert rmse < 0.15, rmse

    def test_octave_spread(self, run):
        """Non-planar depth range exercises multiple pyramid levels."""
        tracker, _ = run
        oct_ = np.asarray(tracker.last_frame.octave)[
            np.asarray(tracker.last_frame.fvalid)]
        assert len(np.unique(oct_)) >= 3


# ---------------------------------------------------------------------------
# SceneWorld: occlusion + shading + exposure drift (VERDICT r4 missing #1 —
# a photometrically realistic validation surface)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    return synthetic.SceneWorld.room_with_boxes(
        CAM, half=14.0, height=3.0, n_boxes=5, box_ring=8.0, seed=3)


class TestSceneWorld:
    def test_boxes_occlude_walls(self, scene):
        """A box between camera and wall produces a large negative depth
        step (occlusion boundary) absent from the bare room."""
        Tcw = se3.inverse(se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -3.0])))
        d = np.asarray(scene.depth(Tcw))
        valid = d > 0
        assert valid.mean() > 0.95
        # Occluders create bimodal depth: some rays hit boxes (< ~12 m),
        # others the walls (>= ~14 m).
        assert (d[valid] < 12.0).mean() > 0.05
        assert (d[valid] > 13.0).mean() > 0.2
        # Discontinuity magnitude at box silhouettes.
        jump = np.abs(np.diff(d, axis=1))
        assert jump.max() > 3.0

    def test_exposure_varies_but_structure_stable(self, scene):
        Tcw = se3.identity()
        a = np.asarray(scene.render(Tcw, frame=0))
        b = np.asarray(scene.render(Tcw, frame=40))
        # Exposure drift changes global brightness between distant frames...
        assert abs(a.mean() - b.mean()) > 2.0
        # ...but the underlying structure stays put (high correlation).
        an = (a - a.mean()) / a.std()
        bn = (b - b.mean()) / b.std()
        assert (an * bn).mean() > 0.9

    def test_stereo_tracking_e2e(self, scene):
        """Short stereo run through the occluded scene: tracking must hold
        and the ATE must stay at the few-cm level despite occlusion
        boundaries, shading and exposure drift."""
        tracker = StereoTracker(CAM, CFG)
        n = 18
        gt = []
        for i in range(n):
            th = 0.035 * i
            Twc = se3.compose(
                se3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
                se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -6.0])),
            )
            gt.append(se3.inverse(Twc))
        for i, Tcw in enumerate(gt):
            l, r = scene.render_stereo(Tcw, frame=i)
            tracker.process_stereo(l, r, timestamp=i * 0.1)
        tracker.flush()
        assert tracker.state == TrackState.OK
        est = np.asarray([np.asarray(se3.inverse(jnp.asarray(T)))
                          for _, T in tracker.trajectory])
        gtw = np.asarray([np.asarray(se3.inverse(T)) for T in gt])
        rmse = trajectory.ate_rmse(est, gtw, align=True)
        assert rmse < 0.08, rmse
