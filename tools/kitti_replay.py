"""Replay a real KITTI odometry sequence end to end and report fps + ATE.

The reference's validation is exactly this: replay sequences/NN through the
client at dataset pace and compare the saved trajectory against ground
truth (ref: corbslam_client/Examples/Stereo/stereo_kitti.cc:96-116,
System::SaveTrajectoryKITTI System.cc:350). The container ships no dataset,
so bench.py invokes this only when ./sequences exists (drop a KITTI
odometry root next to bench.py to activate it).

Layout expected under --root:
  sequences/NN/{image_0,image_1,times.txt}
  poses/NN.txt            (optional ground truth -> ATE)

Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def replay(root: str, seq: int = -1, max_frames: int = 300,
           loop_closing: bool = True) -> dict:
    """Replay sequences/<seq> under `root` through CorbslamClient; returns
    fps over the frames after the first few and, when poses/<seq>.txt
    exists, the aligned ATE."""
    import jax.numpy as jnp
    import numpy as np

    from corbslam import system as system_mod
    from corbslam.io import datasets, trajectory
    from corbslam.place import vocab as vocab_mod

    if seq < 0:
        names = sorted(os.listdir(os.path.join(root, "sequences")))
        seq = int(names[0])
    frames = datasets.load_kitti_stereo(root, seq)
    if max_frames:
        frames = frames[:max_frames]
    cam = datasets.kitti_camera(seq)
    cfg = datasets.config_for("kitti")

    voc = vocab_mod.load_default() if loop_closing else None
    client = system_mod.CorbslamClient(
        cam, cfg, sensor="stereo", client_id=1, voc=voc,
        enable_loop_closing=voc is not None,
    )

    # The first frames compile the program suite; time the rest.
    n_warm = min(10, len(frames) // 4)
    for fr in frames[:n_warm]:
        l, r = fr.load()
        client.track_stereo(jnp.asarray(l), jnp.asarray(r), fr.timestamp)
    client.tracker.flush()
    t0 = time.perf_counter()
    for fr in frames[n_warm:]:
        l, r = fr.load()
        client.track_stereo(jnp.asarray(l), jnp.asarray(r), fr.timestamp)
    client.shutdown()
    dt = time.perf_counter() - t0

    out = {
        "seq": seq,
        "frames": len(frames),
        "fps": (len(frames) - n_warm) / dt,
        "n_keyframes": int(client.tracker.stats.n_keyframes),
        "states": {
            s.name: sum(1 for x in client.tracker.frame_states if x == s)
            for s in set(client.tracker.frame_states)
        },
    }
    gt_path = os.path.join(root, "poses", f"{seq:02d}.txt")
    if os.path.exists(gt_path):
        gt = np.loadtxt(gt_path)[: len(frames)].reshape(-1, 3, 4)
        est = np.asarray([np.linalg.inv(np.asarray(T))
                          for _, T in client.tracker.trajectory])[: len(gt)]
        gt44 = np.tile(np.eye(4, dtype=np.float64), (len(gt), 1, 1))
        gt44[:, :3, :4] = gt
        out["ate_rmse"] = float(trajectory.ate_rmse(est, gt44, align=True))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seq", type=int, default=-1,
                    help="-1 = first sequence found")
    ap.add_argument("--max-frames", type=int, default=300)
    ap.add_argument("--no-loop-closing", action="store_true")
    args = ap.parse_args()

    from corbslam import compile_cache

    compile_cache.configure()
    print(json.dumps(replay(args.root, args.seq, args.max_frames,
                            not args.no_loop_closing)))


if __name__ == "__main__":
    main()
