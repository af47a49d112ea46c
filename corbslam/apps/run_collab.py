"""Multi-client collaborative SLAM runner (hermetic).

Replaces the reference's multi-terminal launch recipe (ref: README.md:55-75
— roscore + corbslam_server + N dataset clients with a 40 s startup sleep,
stereo_kitti.cc:68): N tracking clients with DIFFERENT world frames explore
one synthetic scene, sync through the in-process transport to the fusion
server, which detects their overlap, merges the maps, and broadcasts the
fused global map back.

    python -m corbslam.apps.run_collab --clients 2 --frames 30
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--gba", action="store_true", help="run global BA on fusion")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from .. import system as system_mod
    from ..collab.server import MapFusionServer
    from ..collab.transport import InProcTransport
    from ..config import CapacityConfig, OrbConfig, SlamConfig
    from ..geometry import camera, se3
    from ..io import synthetic
    from ..place import vocab as vocab_mod

    cam = camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240
    )
    cfg = SlamConfig(
        orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
        capacity=CapacityConfig(
            max_keyframes=256, max_map_points=32768, max_features=512,
            local_window_kfs=8, local_window_mps=2048,
        ),
    )
    world = synthetic.PlanarWorld(
        cam, texture_size=2048, plane_dist=10.0, texture_scale=40.0
    )
    tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))

    # Vocabulary: shipped artifact first, inline bootstrap as fallback.
    voc = vocab_mod.load_default()
    if voc is None:
        from ..frontend import frame as frame_mod

        img0, _ = world.render_stereo(tilt)
        f0 = frame_mod.build_frame_mono(img0, cam, cfg.orb)
        voc = vocab_mod.train(f0.desc, n_words=512, n_iters=5)

    transport = InProcTransport(serialize=True)
    server = MapFusionServer(
        cam, cfg, voc, transport, run_gba=args.gba, synchronous_gba=True
    )

    # Each client's OWN world frame differs by a known offset; trajectories
    # overlap in the scene so the server can align them.
    def gt_pose(i, k):
        xi = jnp.asarray(
            [-(i * 0.12) - k * 0.4, 0.0, -(i * 0.03), 0.0, i * 0.004, 0.0],
            jnp.float32,
        )
        return se3.compose(tilt, se3.exp(xi))  # Tcw in the GT frame

    # Each tracker's world frame is its own first camera pose; staggered
    # start positions (k * 0.4 in x) give every client a DIFFERENT frame,
    # exactly like independent robots (no explicit offsets needed).
    clients = []
    for k in range(args.clients):
        c = system_mod.CorbslamClient(
            cam, cfg, sensor="stereo", client_id=k + 1, voc=voc,
            transport=transport, enable_loop_closing=False,
        )
        c.uplink_every = 10
        c.downlink_every = 5
        clients.append(c)

    for i in range(args.frames):
        for k, c in enumerate(clients):
            l, r = world.render_stereo(gt_pose(i, k))
            c.track_stereo(l, r, timestamp=i * 0.1)
        if i % 5 == 4:
            server.fuse_step()
            server.broadcast_step()

    for c in clients:
        c.shutdown()
    server.fuse_step()
    server.broadcast_step()
    for c in clients:
        c.cache.downlink_step()  # the final broadcast reaches every client

    print(f"[run_collab] fusions: {server.stats['fusions']}, "
          f"kfs received: {server.stats['kfs_received']}, "
          f"global map: {int(server.gmap.n_kf)} KFs / "
          f"{int(np.asarray(server.gmap.mp.valid).sum())} MPs")
    for k, c in enumerate(clients):
        st = c.cache.stats
        print(f"[run_collab] client {k + 1}: pushed {st['kfs_pushed']} KFs, "
              f"received {st['foreign_kfs']} foreign KFs, "
              f"transM known: {c.cache.Ttrans is not None}")
    return server, clients


if __name__ == "__main__":
    from .. import compile_cache

    compile_cache.configure()
    main()
