"""Map compaction tests (mapstate.compact — the eviction half of the
fixed-capacity growth model, SURVEY.md §5.7; the reference's std::set maps
shrink for free when keyframes are culled, Map.cc)."""

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.config import CapacityConfig, MappingConfig, OrbConfig, SlamConfig, TrackingConfig
from corbslam.mapstate import mapstate as ms


def _toy_map(rng, n_kf=10, n_mp=40, cap_kf=16, cap_mp=64, F=8):
    cap = CapacityConfig(max_keyframes=cap_kf, max_map_points=cap_mp,
                         max_features=F, local_window_kfs=4,
                         local_window_mps=16)
    m = ms.empty(cap)
    for p in range(n_mp):
        m, _ = ms.add_map_points(
            m, jnp.asarray(rng.normal(size=(1, 3)), jnp.float32),
            jnp.zeros((1, 32), jnp.uint8), jnp.zeros((1, 3)),
            jnp.ones(1), jnp.ones(1) * 2,
            ref_kf=p % n_kf, create=jnp.ones(1, bool))
    for k in range(n_kf):
        mp_idx = jnp.asarray(
            [(k * F + f) % n_mp if f % 2 == 0 else -1 for f in range(F)],
            jnp.int32)
        m, _ = ms.insert_keyframe(
            m, jnp.eye(4).at[0, 3].set(float(k)),
            jnp.zeros((F, 2)), jnp.zeros(F, jnp.int32), jnp.zeros(F),
            jnp.zeros((F, 32), jnp.uint8), jnp.full(F, -1.0), jnp.zeros(F),
            jnp.ones(F, bool), mp_idx, frame_id=k, timestamp=0.1 * k)
    return m


class TestCompact:
    def test_repack_preserves_content_and_references(self, rng):
        m = _toy_map(rng)
        kill_kf = jnp.zeros(16, bool).at[jnp.asarray([2, 5])].set(True)
        m = ms.cull_keyframes(m, kill_kf)
        kill_mp = jnp.zeros(64, bool).at[jnp.asarray([0, 7, 13])].set(True)
        m = ms.cull_map_points(m, kill_mp)

        res = ms.compact(m)
        m2 = res.m
        assert int(m2.n_kf) == 8
        assert int(m2.n_mp) == 37
        # Valid rows are a contiguous prefix.
        assert np.asarray(m2.kf.valid)[:8].all()
        assert not np.asarray(m2.kf.valid)[8:].any()
        # Stable order: surviving keyframes keep time order (x = old k).
        xs = np.asarray(m2.kf.Tcw)[:8, 0, 3]
        assert (np.diff(xs) > 0).all()
        assert not np.isin(xs, [2.0, 5.0]).any()
        # Observations still point at the same landmark positions.
        old_pos = np.asarray(m.mp.pos)
        new_pos = np.asarray(m2.mp.pos)
        old_idx = np.asarray(m.kf.mp_idx)
        new_idx = np.asarray(m2.kf.mp_idx)
        kmap = np.asarray(res.kf_old2new)
        for old_row in range(16):
            nr = kmap[old_row]
            if nr < 0:
                continue
            for f in range(8):
                oi, ni = old_idx[old_row, f], new_idx[nr, f]
                if oi >= 0 and not bool(kill_mp[oi]):
                    assert ni >= 0
                    np.testing.assert_allclose(new_pos[ni], old_pos[oi])
                else:
                    assert ni == ms.NO_MP

    def test_ref_kf_remapped(self, rng):
        m = _toy_map(rng)
        m = ms.cull_keyframes(m, jnp.zeros(16, bool).at[0].set(True))
        res = ms.compact(m)
        refs = np.asarray(res.m.mp.ref_kf)[: int(res.m.n_mp)]
        assert (refs >= 0).all() and (refs < int(res.m.n_kf)).all()


class TestCompactionEndToEnd:
    def test_tracker_compacts_and_keeps_tracking(self, rng):
        """Force the cursor near a tiny capacity; the tracker must repack
        (reclaiming culled rows) and keep tracking without corruption."""
        from corbslam.frontend.tracking import StereoTracker, TrackState
        from corbslam.geometry import camera, se3
        from corbslam.io import synthetic

        cam = camera.Intrinsics.create(
            fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
            width=320, height=240)
        cfg = SlamConfig(
            orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
            tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=2),
            mapping=MappingConfig(local_ba_window=4, local_ba_iters=4),
            capacity=CapacityConfig(
                max_keyframes=24, max_map_points=16384, max_features=512,
                local_window_kfs=4, local_window_mps=1024),
        )
        world = synthetic.PlanarWorld(
            cam, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
        tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
        t = StereoTracker(cam, cfg)
        for i in range(40):  # max 2 frames/KF -> cursor passes 0.85*24
            xi = jnp.asarray([-(i * 0.1), 0.0, -(i * 0.02), 0.0, i * 0.003,
                              0.0], jnp.float32)
            l, r = world.render_stereo(se3.compose(tilt, se3.exp(xi)))
            t.process_stereo(l, r, i * 0.1)
        t.flush()
        assert t.state == TrackState.OK
        assert int(t.map.n_kf) <= 24
        # Compaction actually happened (cursor stayed below the gate even
        # though ~20 keyframes were created).
        assert t.stats.n_keyframes >= 18
        # Map is internally consistent after repack(s).
        idx = np.asarray(t.map.kf.mp_idx)
        valid_mp = np.asarray(t.map.mp.valid)
        bound = idx[idx >= 0]
        assert (bound < t.map.mp.capacity).all()
        assert valid_mp[bound].mean() > 0.95  # few stragglers at most


class TestCollabCompactionE2E:
    def test_tracker_compacts_with_live_sync_cache(self, rng):
        """The full pipeline with a live ClientCache and a tiny keyframe
        capacity: compaction must fire MID-RUN, remap the cache through
        the on_compact hook, and the uplink must stay consistent (unique
        gids, no dropped entities) — §5.7 eviction composed with the
        collaboration layer, which round 3 explicitly disabled."""
        from corbslam import system as system_mod
        from corbslam.collab.server import MapFusionServer
        from corbslam.collab.transport import InProcTransport
        from corbslam.frontend import frame as frame_mod
        from corbslam.geometry import camera, se3
        from corbslam.io import synthetic
        from corbslam.place import vocab as vocab_mod

        cam = camera.Intrinsics.create(
            fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
            width=320, height=240)
        cfg = SlamConfig(
            orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
            tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=2),
            mapping=MappingConfig(local_ba_window=4, local_ba_iters=4),
            capacity=CapacityConfig(
                max_keyframes=24, max_map_points=16384, max_features=512,
                local_window_kfs=4, local_window_mps=1024),
        )
        world = synthetic.PlanarWorld(
            cam, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
        tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
        img0, _ = world.render_stereo(tilt)
        f0 = frame_mod.build_frame_mono(img0, cam, cfg.orb)
        voc = vocab_mod.train(f0.desc, n_words=256, n_iters=4)

        transport = InProcTransport(serialize=True)
        server = MapFusionServer(cam, cfg, voc, transport, run_gba=False)
        c = system_mod.CorbslamClient(
            cam, cfg, sensor="stereo", client_id=1, voc=None,
            transport=transport, enable_loop_closing=False,
        )
        c.cache.stop_async_uplink()  # deterministic synchronous sync
        c.uplink_every = 6
        c.downlink_every = 1000
        assert c.tracker.compaction_enabled  # no longer disabled by collab

        for i in range(40):
            xi = jnp.asarray(
                [-(i * 0.1), 0.0, -(i * 0.02), 0.0, i * 0.003, 0.0],
                jnp.float32)
            l, r = world.render_stereo(se3.compose(tilt, se3.exp(xi)))
            c.track_stereo(l, r, i * 0.1)
            server.fuse_step()
        c.shutdown()

        t = c.tracker
        assert t.stats.n_keyframes >= 18          # many created...
        assert int(t.map.n_kf) <= 24              # ...cursor stayed bounded
        # Sync stayed consistent: entities reached the server, gids unique.
        assert c.cache.stats["kfs_pushed"] > 0
        assert c.cache.stats["mps_pushed"] > 0
        g = c.cache.kf_ids.gid_of_row
        vals = g[g >= 0]
        assert len(np.unique(vals)) == len(vals)
        gm = c.cache.mp_ids.gid_of_row
        vals = gm[gm >= 0]
        assert len(np.unique(vals)) == len(vals)
        assert server.stats["kfs_received"] > 0
