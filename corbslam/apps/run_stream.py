"""Live streaming SLAM node — the ROS example-node capability.

Reference: corbslam_client/Examples/ROS/ORB_SLAM2/src/ros_stereo.cc (live
stereo node: subscribe left+right image topics, ApproximateTime sync, feed
System::TrackStereo), ros_mono.cc, ros_rgbd.cc. Here the same deployment
shape without ROS: a `publisher` role streams a dataset (or synthetic
frames) over TCP at a chosen fps; the `node` role subscribes, pairs
left/right with ApproxSync, and drives a CorbslamClient as frames arrive —
dropping frames honestly when tracking is slower than the stream (the live
constraint dataset replay can fake, stereo_kitti.cc:108-116 sleeps instead).

    # terminal 1 (node — prints the port):
    python -m corbslam.apps.run_stream --role node --portfile /tmp/p
    # terminal 2 (publisher):
    python -m corbslam.apps.run_stream --role publisher \
        --portfile /tmp/p --fps 10 --frames 100
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def _camera():
    from ..geometry import camera

    return camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320,
        height=240,
    )


def _cfg():
    from ..config import CapacityConfig, OrbConfig, SlamConfig

    return SlamConfig(
        orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
        capacity=CapacityConfig(
            max_keyframes=256, max_map_points=32768, max_features=512,
            local_window_kfs=8, local_window_mps=2048,
        ),
    )


def run_publisher(args):
    """Camera-driver stand-in: synthetic stereo frames at --fps."""
    import jax.numpy as jnp

    from ..geometry import se3
    from ..io import synthetic
    from ..io.stream import ImageStreamServer

    cam = _camera()
    world = synthetic.PlanarWorld(
        cam, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))

    srv = ImageStreamServer()
    with open(args.portfile + ".tmp", "w") as f:
        f.write(str(srv.port))
    os.rename(args.portfile + ".tmp", args.portfile)
    print(f"[publisher] listening on {srv.port}")
    srv.wait_subscriber()
    period = 1.0 / args.fps
    for i in range(args.frames):
        t_next = time.time() + period
        xi = jnp.asarray([-(i * 0.12), 0.0, -(i * 0.03), 0.0, i * 0.004, 0.0],
                         jnp.float32)
        l, r = world.render_stereo(se3.compose(tilt, se3.exp(xi)))
        ts = time.time()
        srv.publish("left", ts, np.asarray(l, np.float32))
        srv.publish("right", ts, np.asarray(r, np.float32))
        time.sleep(max(0.0, t_next - time.time()))
    srv.end()
    time.sleep(0.5)
    srv.close()
    print(f"[publisher] streamed {args.frames} frames at {args.fps} fps")


def run_node(args):
    """The live SLAM node (ros_stereo.cc equivalent)."""
    from .. import system as system_mod
    from ..io.stream import ApproxSync, ImageStreamClient

    cam, cfg = _camera(), _cfg()
    t0 = time.time()
    while not os.path.exists(args.portfile):
        if time.time() - t0 > 60:
            raise RuntimeError("no publisher portfile")
        time.sleep(0.05)
    port = int(open(args.portfile).read())
    sub = ImageStreamClient(port=port)
    sync = ApproxSync(slop=0.02)
    c = system_mod.CorbslamClient(
        cam, cfg, sensor="stereo", client_id=1, enable_loop_closing=False)

    n_in = n_tracked = 0
    while True:
        for ts, img in sub.pop_all("left"):
            sync.push_a(ts, img)
            n_in += 1
        for ts, img in sub.pop_all("right"):
            sync.push_b(ts, img)
        pairs = sync.pop_pairs()
        # Live semantics: when the tracker lags the stream, only the NEWEST
        # synced pair is processed and older ones are dropped (a live node
        # can't pause the camera; the reference's dataset replay sleeps).
        if pairs:
            ts, l, r = pairs[-1]
            c.track_stereo(l, r, ts)
            n_tracked += 1
        elif sub.ended:
            break
        else:
            time.sleep(0.002)
    c.shutdown()
    out = {
        "frames_streamed": n_in,
        "frames_tracked": n_tracked,
        "drop_rate": round(1.0 - n_tracked / max(n_in, 1), 3),
        "n_keyframes": int(c.tracker.stats.n_keyframes),
        "states": {
            s.name: sum(1 for x in c.tracker.frame_states if x == s)
            for s in set(c.tracker.frame_states)
        },
    }
    print(f"[node] {json.dumps(out)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    sub.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["publisher", "node", "demo"],
                    default="demo")
    ap.add_argument("--portfile", default=os.path.join(
        tempfile.gettempdir(), "corbslam_stream_port"))
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.role == "publisher":
        run_publisher(args)
    elif args.role == "node":
        run_node(args)
    else:
        # demo: spawn the publisher in a child process, run the node here.
        import subprocess
        import sys

        if os.path.exists(args.portfile):
            os.unlink(args.portfile)
        # The publisher stays off the accelerator: the node in this process
        # owns the card.
        pub = subprocess.Popen([
            sys.executable, "-m", "corbslam.apps.run_stream",
            "--role", "publisher", "--portfile", args.portfile,
            "--fps", str(args.fps), "--frames", str(args.frames),
        ], env={**os.environ, "JAX_PLATFORMS": "cpu"})
        try:
            run_node(args)
        finally:
            pub.wait()


if __name__ == "__main__":
    from .. import compile_cache

    compile_cache.configure()
    main()
