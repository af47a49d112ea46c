"""End-to-end loop-closure validation: a closed orbit inside the room world
driven through CorbslamClient with loop closing + GBA enabled
(`corbslam.checks.closed_orbit`). Reports whether the loop fired and the ATE
of the frames and of the corrected keyframes — the reference's KITTI-00
manual validation (ref: corbslam_client/src/LoopClosing.cc:404 CorrectLoop
end-to-end effect), done hermetically on a synthetic world. Runs on the
default JAX platform.

Run: python -u tools/loop_e2e.py [--frames N] [--step S] [--radius R]
Prints one JSON line with loop stats + ATE.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--step", type=float, default=0.10)
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--extra", type=int, default=8,
                    help="frames past closure")
    args = ap.parse_args()

    from corbslam import checks, compile_cache

    compile_cache.configure()
    out = checks.closed_orbit(step=args.step, radius=args.radius,
                              extra=args.extra, frames=args.frames,
                              log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
