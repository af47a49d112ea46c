"""System facade tests: the CorbslamClient wrapper (System.cc equivalent),
trajectory export in both formats, map checkpoint/restore, keyframe
culling, metrics emission, and the CLI runners."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam import system as system_mod
from corbslam.config import CapacityConfig, MappingConfig, OrbConfig, SlamConfig, TrackingConfig
from corbslam.geometry import camera, se3
from corbslam.io import synthetic
from corbslam.place import vocab as vocab_mod

CAM = camera.Intrinsics.create(
    fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240
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
    return synthetic.PlanarWorld(CAM, texture_size=2048, plane_dist=10.0,
                                 texture_scale=40.0)


def drive(client, world, n=10, dx=0.12):
    tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    for i in range(n):
        xi = jnp.asarray([-(i * dx), 0.0, -(i * 0.03), 0.0, i * 0.004, 0.0],
                         jnp.float32)
        l, r = world.render_stereo(se3.compose(tilt, se3.exp(xi)))
        client.track_stereo(l, r, timestamp=i * 0.1)


class TestSystemFacade:
    def test_track_export_checkpoint(self, world, tmp_path):
        client = system_mod.CorbslamClient(
            CAM, CFG, sensor="stereo", client_id=1, voc=None,
            enable_loop_closing=False,
            metrics_path=str(tmp_path / "metrics.jsonl"),
        )
        drive(client, world, n=8)
        client.shutdown()

        # Trajectory exports.
        client.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
        rows = np.loadtxt(tmp_path / "kitti.txt")
        assert rows.shape == (8, 12)
        client.save_trajectory_tum(str(tmp_path / "tum.txt"))
        tum = np.loadtxt(tmp_path / "tum.txt")
        assert tum.shape == (8, 8)
        client.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
        kfs = np.loadtxt(tmp_path / "kf.txt").reshape(-1, 8)
        assert len(kfs) == int(jnp.sum(client.tracker.map.kf.valid))

        # Metrics JSONL (SURVEY.md §5.5: structured per-frame counters).
        lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
        assert len(lines) == 8
        assert {"t", "state", "track_ms", "n_kf", "n_mp", "inliers"} <= set(lines[0])

        # Checkpoint round-trip.
        client.save_map(str(tmp_path / "map.npz"))
        client2 = system_mod.CorbslamClient(
            CAM, CFG, sensor="stereo", client_id=1, voc=None,
            enable_loop_closing=False,
        )
        client2.load_map(str(tmp_path / "map.npz"))
        m1, m2 = client.tracker.map, client2.tracker.map
        assert int(m1.n_kf) == int(m2.n_kf)
        assert np.allclose(np.asarray(m1.kf.Tcw), np.asarray(m2.kf.Tcw))
        assert np.allclose(np.asarray(m1.mp.pos), np.asarray(m2.mp.pos))

    def test_keyframe_culling_activates(self, world):
        # A near-stationary camera spawns redundant keyframes -> culling
        # must invalidate some of them.
        from corbslam.mapping import local_mapping

        client = system_mod.CorbslamClient(
            CAM, CFG.replace(
                tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=2),
            ),
            sensor="stereo", client_id=1, voc=None, enable_loop_closing=False,
        )
        drive(client, world, n=14, dx=0.015)
        client.tracker.flush()  # drain deferred mapping stages (incl. culling)
        m = client.tracker.map
        n_alloc = int(m.n_kf)
        n_valid = int(jnp.sum(m.kf.valid))
        assert n_alloc > n_valid, (n_alloc, n_valid)


class TestRunnerApps:
    def test_run_client_synthetic(self, tmp_path, monkeypatch):
        from corbslam.apps import run_client

        out = tmp_path / "traj.txt"
        client = run_client.main([
            "--dataset", "synthetic", "--n-frames", "8",
            "--no-loop-closing", "--out", str(out),
        ])
        assert out.exists()
        assert np.loadtxt(out).shape[1] == 12


class TestDatasetLoaders:
    def _write_pgm(self, path, arr):
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.astype(np.uint8).tobytes())

    def test_kitti_layout(self, tmp_path, rng):
        sdir = tmp_path / "sequences" / "03"
        (sdir / "image_0").mkdir(parents=True)
        (sdir / "image_1").mkdir()
        img = rng.integers(0, 255, (8, 12), dtype=np.uint8)
        for i in range(3):
            self._write_pgm(sdir / "image_0" / f"{i:06d}.pgm", img)
            self._write_pgm(sdir / "image_1" / f"{i:06d}.pgm", img)
        np.savetxt(sdir / "times.txt", np.arange(3) * 0.1)

        from corbslam.io import datasets

        frames = datasets.load_kitti_stereo(str(tmp_path), 3)
        assert len(frames) == 3
        l, r = frames[1].load()
        assert l.shape == (8, 12) and abs(frames[1].timestamp - 0.1) < 1e-9
        cam = datasets.kitti_camera(3)
        assert abs(cam.fx - 721.5377) < 1e-3

    def test_tum_association(self, tmp_path, rng):
        img = rng.integers(0, 255, (6, 6), dtype=np.uint8)
        (tmp_path / "rgb").mkdir()
        (tmp_path / "depth").mkdir()
        rgb_lines, d_lines = ["# comment"], []
        for i in range(3):
            t = 100.0 + i * 0.05
            self._write_pgm(tmp_path / "rgb" / f"{t:.4f}.pgm", img)
            self._write_pgm(tmp_path / "depth" / f"{t + 0.008:.4f}.pgm", img)
            rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.pgm")
            d_lines.append(f"{t + 0.008:.4f} depth/{t + 0.008:.4f}.pgm")
        (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines))
        (tmp_path / "depth.txt").write_text("\n".join(d_lines))

        from corbslam.io import datasets

        frames = datasets.load_tum_rgbd(str(tmp_path))
        assert len(frames) == 3
        rgb, depth = frames[0].load()
        assert rgb.shape == (6, 6)
        assert depth.max() <= 255 / 5000.0 + 1e-9

    def test_euroc_layout(self, tmp_path, rng):
        img = rng.integers(0, 255, (6, 6), dtype=np.uint8)
        for c in ("cam0", "cam1"):
            (tmp_path / "mav0" / c / "data").mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for i in range(2):
            ns = 1403636579763555584 + i * 50_000_000
            name = f"{ns}.pgm"
            self._write_pgm(tmp_path / "mav0" / "cam0" / "data" / name, img)
            self._write_pgm(tmp_path / "mav0" / "cam1" / "data" / name, img)
            rows.append(f"{ns},{name}")
        (tmp_path / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows))

        from corbslam.io import datasets

        frames = datasets.load_euroc_stereo(str(tmp_path))
        assert len(frames) == 2
        l, r = frames[0].load()
        assert l.shape == (6, 6)
