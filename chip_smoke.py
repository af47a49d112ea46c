"""Smoke test of the whole system on one NVIDIA GPU.

    python chip_smoke.py          # phases 0-5 on one card
    python chip_smoke.py --four   # only the camera-sharded GBA on four cards,
                                  # against the same problem on one card

Phases: 0 device check; 1 ORB front end against the CPU backend and the
NumPy references at KITTI geometry; 2 one stereo client (loop closing and
GBA on) at KITTI geometry; 3 closed-orbit loop closure; 4 two clients and
the fusion server in this process; 5 global BA at the bench's size. Any
failure exits non-zero. The last line of standard output is one JSON object
naming the device. One process owns the card; the only child is nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def phase_tracking(card, compiles, voc, n_frames=120, n_skip=20):
    """One stereo client through the normal entry point at KITTI geometry.

    A first client runs the whole sequence to compile every program (the
    set-up time); a fresh client then runs it again and frames n_skip.. are
    timed."""
    import jax
    import numpy as np

    from corbslam import checks, system
    from corbslam.config import KITTI_STEREO
    from corbslam.frontend.tracking import TrackState

    cam = checks.KITTI_CAM
    world, gt_pose = checks.planar_world(cam)
    render = jax.jit(lambda T: world.render_stereo(T))
    frames = [render(gt_pose(i)) for i in range(n_frames)]
    jax.block_until_ready(frames)

    def client():
        return system.CorbslamClient(cam, KITTI_STEREO, sensor="stereo",
                                     voc=voc, enable_loop_closing=True,
                                     run_gba=True)

    t0 = time.perf_counter()
    c = client()
    for i in range(n_frames):
        c.track_stereo(*frames[i], timestamp=i * 0.1)
    c.shutdown()
    setup_s = time.perf_counter() - t0

    c = client()
    for i in range(n_skip):
        c.track_stereo(*frames[i], timestamp=i * 0.1)
    c.tracker.flush()
    n_compiles0, secs0 = compiles.n, compiles.secs
    lat = []
    t0 = time.perf_counter()
    for i in range(n_skip, n_frames):
        tf = time.perf_counter()
        c.track_stereo(*frames[i], timestamp=i * 0.1)
        lat.append(time.perf_counter() - tf)
    c.tracker.flush()
    jax.block_until_ready(c.tracker.map.kf.Tcw)
    wall = time.perf_counter() - t0
    c.shutdown()

    states = c.tracker.frame_states
    assert all(s == TrackState.OK for s in states[2:]), states
    traj = c.tracker.trajectory
    assert np.isfinite(np.asarray([T for _, T in traj])).all()
    ate = checks.window_ate(traj, gt_pose)
    lat_ms = np.asarray(lat) * 1e3
    out = {
        "fps": (n_frames - n_skip) / wall,
        "frame_ms_p50": float(np.percentile(lat_ms, 50)),
        "frame_ms_p90": float(np.percentile(lat_ms, 90)),
        "setup_s": setup_s,
        "compiles_in_timed_window": compiles.n - n_compiles0,
        "compile_s_in_timed_window": compiles.secs - secs0,
        "keyframes": int(c.tracker.stats.n_keyframes),
        "ate_window_m": ate,
    }
    print(f"[tracking] {out} [{card}]", flush=True)
    assert ate <= 0.15, ate
    return out


def phase_collab(card):
    from corbslam.apps import run_collab

    t0 = time.perf_counter()
    server, clients = run_collab.main(["--clients", "2", "--frames", "60",
                                       "--gba"])
    fusions = server.stats["fusions"]
    known = [c.cache.Ttrans is not None for c in clients]
    print(f"[collab] fusions {fusions}, transM known {known}, "
          f"wall {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    assert fusions >= 1 and all(known), (fusions, known)


def four_card_gba(card):
    """The camera-sharded GBA over four cards against one card."""
    import jax
    import numpy as np

    from corbslam import checks
    from corbslam.config import KITTI_STEREO
    from corbslam.loop import gba as gba_mod
    from corbslam.parallel import distributed_ba as dba

    devs = jax.devices()
    assert len(devs) == 4, devs
    cam = checks.KITTI_CAM
    m, cfg = checks.gba_map(cam, KITTI_STEREO, **checks.GBA_SIZE,
                            point_noise=0.02)
    n_kf, n_pts = checks.GBA_SIZE["n_kf"], checks.GBA_SIZE["n_pts"]
    one = jax.sharding.Mesh(np.asarray(devs[:1]), (dba.AXIS,))
    results, peaks = {}, None
    for name, mesh in (("four", None), ("one", one)):
        runner = gba_mod.GlobalBARunner(cam, cfg, synchronous=True, mesh=mesh)
        assert runner.mesh is not None
        walls = []
        for _ in range(2):  # the first run compiles
            t0 = time.perf_counter()
            runner.launch(m)
            m2 = runner.try_merge(m)
            jax.block_until_ready(m2.kf.Tcw)
            walls.append(time.perf_counter() - t0)
        results[name] = (np.asarray(m2.kf.Tcw)[:n_kf],
                         np.asarray(m2.mp.pos)[:n_pts])
        if peaks is None:
            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                     for d in devs]
        print(f"[four] {name}: mesh {runner.mesh.devices.size} card(s), "
              f"wall {walls[1]:.4f} s (first run {walls[0]:.4f} s) "
              f"[{card}]", flush=True)
    print(f"[four] peak_bytes_in_use per card after the sharded runs: "
          f"{peaks}", flush=True)
    (T4, X4), (T1, X1) = results["four"], results["one"]
    dT = float(np.abs(T4 - T1).max())
    dX = np.linalg.norm(X4 - X1, axis=1)
    print(f"[four] four vs one: pose max abs diff {dT:.3g}, point diff "
          f"median {np.median(dX):.3g} m, p99 {np.percentile(dX, 99):.3g} m, "
          f"max {dX.max():.3g} m", flush=True)
    assert np.isfinite(T4).all() and np.isfinite(X4).all()
    # The sharded sums reduce in another order, so after 10 LM iterations
    # the runs differ in rounding. Landmarks far down the path are weakly
    # constrained in depth and move most; the bulk must agree to a mm.
    assert dT < 1e-2, dT
    assert np.median(dX) < 1e-3 and np.percentile(dX, 99) < 5e-2, dX.max()
    # Each card must have held at least its quarter of the observation
    # planes (obs_mp, u/v/uR, inv_sigma2, stereo and active flags: 22 B per
    # observation); card 0 also holds the map the problem is built from.
    quarter = n_kf * checks.GBA_SIZE["obs_per_kf"] * 22 // 4
    assert min(peaks) >= quarter, (peaks, quarter)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the camera-sharded GBA on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from corbslam import checks, compile_cache

    cache = compile_cache.configure()
    import jax

    checks.require_gpu(jax.devices())
    card = checks.card_info()
    dev = jax.devices()[0]
    print(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {card}; jax {jax.__version__}; compile cache {cache}",
          flush=True)
    compiles = checks.CompileCounter()
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s, "
              f"{compiles.n} compiles so far ({compiles.secs:.1f} s) "
              f"[{card}]", flush=True)
        return out

    if args.four:
        timed("four-card GBA", four_card_gba, card)
    else:
        from corbslam.config import KITTI_STEREO
        from corbslam.place import vocab

        voc = vocab.load_default()
        assert voc is not None, "assets/vocab32k.npz missing"
        timed("1 front end", checks.frontend_agreement, checks.KITTI_CAM,
              KITTI_STEREO.orb, voc)
        timed("2 stereo client", phase_tracking, card, compiles, voc)

        def loop():
            out = checks.closed_orbit()
            assert out["loops_closed"] >= 1, out
            assert out["nonfinite_kf_poses"] == 0, out
            assert out["ate_rmse_keyframes_post"] < 0.12, out

        timed("3 loop closure", loop)
        timed("4 collaboration", phase_collab, card)
        timed("5 global BA", checks.gba_check, checks.KITTI_CAM, KITTI_STEREO,
              *checks.GBA_SIZE.values())
    print(f"[done] {time.perf_counter() - t_start:.3f} s, {compiles.n} "
          f"compiles ({compiles.secs:.1f} s) [{card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
