"""FULL-STACK multi-host demo: socket-transport client fleet feeding a
fusion server whose global BA shards over a jax.distributed mesh spanning
TWO processes (VERDICT r4 missing #5).

This composes the two halves proven separately in r4:
  - `corbslam.apps.run_collab_mp` — multi-process client/server
    collaboration over the socket transport (the reference's roscore + N
    machines, corbslam_server/src/main.cpp:49-65);
  - `tools/multihost_gba.py` — the camera-sharded dense LM loop running
    as ONE XLA program across jax.distributed processes.

Topology here: rank 0 = fusion server (owns the global map, serves the
4 services, fuses sub-maps) + GBA lead; rank 1 = GBA participant; N
clients = plain processes on the socket transport. After the fleet
finishes, rank 0 builds the whole-map BA problem from the FUSED global
map (with_pm=False — the sharded path keeps every observation), ships its
shapes then the problem itself to rank 1 via multihost collectives, and
both ranks run the sharded LM loop; rank 0 writes
MULTIHOST_FULLSTACK.json.

Run: python tools/multihost_fullstack.py [--clients 2] [--frames 30]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from corbslam import compile_cache

    compile_cache.configure()
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=2,
        process_id=args.proc,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import Mesh

    from corbslam.config import CapacityConfig, OrbConfig, SlamConfig
    from corbslam.geometry import camera
    from corbslam.loop import gba as gba_mod
    from corbslam.optim import ba_dense
    from corbslam.parallel import distributed_ba as dba

    cam = camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
        width=320, height=240)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
        capacity=CapacityConfig(
            max_keyframes=256, max_map_points=32768, max_features=512,
            local_window_kfs=8, local_window_mps=2048,
        ),
    )
    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, (dba.AXIS,))

    fleet_stats = {}
    if args.proc == 0:
        # ---- run the collaboration fleet (server in THIS process) ------
        from corbslam.collab.server import MapFusionServer
        from corbslam.collab.socket_transport import SocketServerTransport
        from corbslam.place import vocab as vocab_mod

        voc = vocab_mod.load_any(args.vocab)
        transport = SocketServerTransport()
        port = transport.start()
        server = MapFusionServer(cam, cfg, voc, transport,
                                 run_gba=False)
        tmp = args.tmp
        procs = []
        for cid in range(1, args.clients + 1):
            out = os.path.join(tmp, f"client{cid}.json")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "corbslam.apps.run_collab_mp",
                 "--role", "client", "--client-id", str(cid),
                 "--frames", str(args.frames), "--port", str(port),
                 "--transport", "tcp", "--vocab", args.vocab,
                 "--out", out],
                cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
            ), out))
        t_last = 0.0
        t0 = time.time()
        while time.time() - t0 < args.timeout:
            n = transport.serve_calls()
            if time.time() - t_last > 1.0:
                server.fuse_step()
                server.broadcast_step()
                t_last = time.time()
            if all(p.poll() is not None for p, _ in procs):
                break
            if n == 0:
                time.sleep(0.01)
        for _ in range(10):
            transport.serve_calls()
            time.sleep(0.05)
        server.fuse_step()
        server.broadcast_step()
        time.sleep(0.3)
        clients = []
        for p, out in procs:
            p.wait(timeout=30)
            if os.path.exists(out):
                clients.append(json.load(open(out)))
        fleet_stats = {
            "clients": clients,
            "server": {k: v for k, v in server.stats.items()},
            "global_kfs": int(server.gmap.n_kf),
            "global_mps": int(np.asarray(server.gmap.mp.valid).sum()),
        }
        transport.close()

        # ---- whole-map BA problem from the FUSED map -------------------
        m = server.gmap
        prob = gba_mod.build_global_problem_dense(
            m, cfg, n_kf_hint=int(m.n_kf), n_mp_hint=int(m.n_mp),
            with_pm=False)
        shapes = np.asarray([prob.Tcw.shape[0], prob.X.shape[0],
                             prob.obs_mp.shape[1]], np.int32)
    else:
        prob = None
        shapes = np.zeros(3, np.int32)

    # ---- cross-process handoff: shapes, then the problem ---------------
    # Filesystem rendezvous first: the fleet phase takes minutes and the
    # Gloo context behind the broadcast collective times out its key-value
    # rendezvous after ~30 s — rank 1 must not enter the collective until
    # rank 0 is actually ready.
    ready = os.path.join(args.tmp, "fleet_done")
    if args.proc == 0:
        with open(ready, "w") as f:
            f.write("1")
    else:
        t0 = time.time()
        while not os.path.exists(ready):
            if time.time() - t0 > args.timeout:
                raise RuntimeError("rank0 never finished the fleet phase")
            time.sleep(0.5)
    shapes = np.asarray(mhu.broadcast_one_to_all(shapes))
    C, P, Fb = (int(x) for x in shapes)
    if args.proc != 0:
        z = np.zeros
        prob = ba_dense.BADense(
            Tcw=jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))),
            pose_fixed=jnp.asarray(z(C, bool)),
            X=jnp.asarray(z((P, 3), np.float32)),
            point_fixed=jnp.asarray(z(P, bool)),
            obs_mp=jnp.asarray(z((C, Fb), np.int32)),
            obs_uvr=jnp.asarray(z((3, C, Fb), np.float32)),
            obs_inv_sigma2=jnp.asarray(z((C, Fb), np.float32)),
            obs_stereo=jnp.asarray(z((C, Fb), bool)),
            obs_active=jnp.asarray(z((C, Fb), bool)),
        )
    else:
        prob = prob._replace(pm_src=None, pm_ok=None)
    prob = mhu.broadcast_one_to_all(prob)

    # ---- sharded GBA across both processes -----------------------------
    t0 = time.time()
    res = dba.optimize_dense(cam, prob, mesh, n_iters=args.gba_iters,
                             cg_iters=24, huber_iters=3)
    cost = float(res.cost)
    dt = time.time() - t0
    finite = bool(np.isfinite(cost)) and all(
        bool(np.isfinite(np.asarray(s.data)).all())
        for s in res.Tcw.addressable_shards)
    print(f"[rank {args.proc}] mesh={len(devs)}dev cost={cost:.3f} "
          f"wall={dt:.1f}s finite={finite}", file=sys.stderr, flush=True)

    if args.proc == 0:
        out = {
            "n_processes": 2,
            "n_devices_in_mesh": int(len(devs)),
            "fleet": fleet_stats,
            "gba_problem": {"cameras": C, "points": P, "obs_per_cam": Fb},
            "gba_iters": args.gba_iters,
            "gba_final_cost": round(cost, 3),
            "gba_wall_s": round(dt, 1),
            "finite": finite,
        }
        path = os.path.join(REPO, "MULTIHOST_FULLSTACK.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--gba-iters", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--vocab", default=os.path.join(
        REPO, "assets", "vocab32k.npz"))
    ap.add_argument("--proc", type=int, default=-1)
    ap.add_argument("--coordinator", default="127.0.0.1:19781")
    ap.add_argument("--tmp", default="")
    args = ap.parse_args()

    if args.proc >= 0:
        worker(args)
        return

    tmp = tempfile.mkdtemp(prefix="fullstack_")
    args_common = ["--clients", str(args.clients), "--frames",
                   str(args.frames), "--gba-iters", str(args.gba_iters),
                   "--vocab", args.vocab, "--tmp", tmp,
                   "--coordinator", args.coordinator,
                   "--timeout", str(args.timeout)]
    procs = []
    for i in range(2):
        log = open(os.path.join(tmp, f"rank{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__),
             "--proc", str(i)] + args_common,
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log))
    rc = 0
    for i, (p, log) in enumerate(procs):
        rc |= p.wait(timeout=args.timeout + 120)
        log.close()
        print(f"--- rank {i} (exit {p.returncode}; log {log.name}) ---")
        with open(log.name) as f:
            tail = f.readlines()[-25:]
        sys.stdout.writelines(tail)
    sys.exit(rc)


if __name__ == "__main__":
    main()
