"""FrameDrawer / map renderer tests (ref: corbslam_client/src/FrameDrawer.cc
DrawFrame + DrawTextInfo; MapDrawer.cc). Hermetic: a stub tracker state, no
pipeline run."""

import types
import zlib

import jax.numpy as jnp
import numpy as np

from corbslam.apps.frame_drawer import FrameDrawer, save_png
from corbslam.frontend.tracking import TrackState


def _stub_tracker(n_feat=32, h=120, w=160):
    f = types.SimpleNamespace(
        xy=np.column_stack([
            np.linspace(5, w - 5, n_feat), np.linspace(5, h - 5, n_feat)
        ]).astype(np.float32),
        fvalid=np.ones(n_feat, bool),
        mp_idx=np.where(np.arange(n_feat) % 2 == 0, np.arange(n_feat), -1),
        octave=np.zeros(n_feat, np.int32),
    )
    t = types.SimpleNamespace(
        last_frame=f,
        _state=TrackState.OK,
        stats=types.SimpleNamespace(n_keyframes=3),
        map=types.SimpleNamespace(
            mp=types.SimpleNamespace(valid=jnp.ones(64, bool))),
        flush=lambda: None,
    )
    return t


class TestFrameDrawer:
    def test_annotates_tracked_and_untracked(self):
        t = _stub_tracker()
        img = np.full((120, 160), 128, np.uint8)
        rgb = FrameDrawer().draw(img, t)
        assert rgb.shape == (120, 160, 3)
        # Green rectangles for tracked, blue for untracked, both present.
        green = (rgb[:, :, 1] > 200) & (rgb[:, :, 0] < 100)
        blue = (rgb[:, :, 2] > 200) & (rgb[:, :, 1] < 160)
        assert green.sum() > 50
        assert blue.sum() > 20
        # Status bar darkened at the bottom.
        assert rgb[-1].mean() < 128 * 0.5

    def test_lost_banner(self):
        t = _stub_tracker()
        t._state = TrackState.LOST
        rgb = FrameDrawer().draw(np.zeros((120, 160), np.uint8), t)
        red = (rgb[:, :, 0] > 200) & (rgb[:, :, 1] < 100)
        assert red.sum() > 10

    def test_save_png_valid(self, tmp_path):
        rgb = np.random.default_rng(0).integers(
            0, 255, (32, 48, 3), dtype=np.uint8)
        p = str(tmp_path / "f.png")
        save_png(rgb, p)
        raw = open(p, "rb").read()
        assert raw[:8] == b"\x89PNG\r\n\x1a\n"
        # decode IDAT and check the pixel payload round-trips
        i = raw.index(b"IDAT")
        ln = int.from_bytes(raw[i - 4:i], "big")
        pix = zlib.decompress(raw[i + 4:i + 4 + ln])
        rows = [pix[r * (1 + 48 * 3) + 1:(r + 1) * (1 + 48 * 3)]
                for r in range(32)]
        dec = np.frombuffer(b"".join(rows), np.uint8).reshape(32, 48, 3)
        assert (dec == rgb).all()


class TestLiveViewer:
    def test_endpoints_serve_live_content(self):
        """The Pangolin-Viewer-equivalent live HTTP viewer (ref:
        Viewer.cc:52, ServerMapView.cpp:34): frame + map + stats published
        from a running tracker must come back over HTTP as valid PNG/JSON."""
        import json as json_mod
        import time
        import urllib.request

        from corbslam.apps.live_viewer import LiveViewer
        from corbslam.config import CapacityConfig
        from corbslam.mapstate import mapstate as ms

        viewer = LiveViewer(port=0, map_render_hz=100.0)
        try:
            t = _stub_tracker()
            viewer.publish_frame(np.full((120, 160), 100, np.uint8), t)
            viewer.publish_stats({"frame": 7, "state": "OK"})

            m = ms.empty(CapacityConfig(
                max_keyframes=8, max_map_points=64, max_features=8,
                local_window_kfs=4, local_window_mps=16))
            m, _ = ms.insert_keyframe(
                m, jnp.eye(4), jnp.zeros((8, 2)), jnp.zeros(8, jnp.int32),
                jnp.zeros(8), jnp.zeros((8, 32), jnp.uint8),
                jnp.full(8, -1.0), jnp.zeros(8), jnp.ones(8, bool),
                jnp.full(8, -1, jnp.int32), frame_id=0, timestamp=0.0)
            viewer.publish_map(m)

            def get(path):
                with urllib.request.urlopen(viewer.url + path, timeout=10) as r:
                    return r.read()

            page = get("")
            assert b"corbslam live" in page
            frame = get("frame.png")
            assert frame[:8] == b"\x89PNG\r\n\x1a\n"
            stats = json_mod.loads(get("stats.json"))
            assert stats["frame"] == 7
            # The async render thread produces the map PNG shortly.
            for _ in range(100):
                mp = get("map.png")
                if len(mp) > 1000:  # rendered (placeholder is tiny)
                    break
                time.sleep(0.1)
            assert mp[:8] == b"\x89PNG\r\n\x1a\n"
            assert len(mp) > 1000
        finally:
            viewer.close()
