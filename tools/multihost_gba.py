"""Multi-process (multi-host shaped) distributed dense GBA.

Proves the DCN deployment shape of SURVEY.md §5.8 end to end: N separate
Python PROCESSES initialize the JAX distributed runtime
(`jax.distributed.initialize` — the same entry a multi-host GPU cluster
uses, here on the CPU backend so it runs anywhere), build ONE global mesh
over all processes' devices, and run the production camera-sharded dense
LM loop (`parallel/distributed_ba.optimize_dense`, the engine the server's
GlobalBARunner dispatches) with its psums riding the cross-process
collective fabric (gRPC here; NCCL across GPU hosts). It measures the
host-side distributed path only, never device throughput.

The reference's deployment story is roscore + N machines
(corbslam_server/src/main.cpp:49-65, README.md:55-75); this is the
JAX equivalent: one controller per host, one global XLA program.

Run (single machine, 2 processes):
    python tools/multihost_gba.py --nprocs 2
Each worker prints its view; process 0 prints the final JSON line with the
converged cost and a cross-process agreement check.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_problem(cam, cfg, n_kf=64, n_mp=2048, obs_per_kf=128, seed=0):
    """Deterministic synthetic BA problem — every process builds the same
    one (the map state would arrive via the collab transport in production;
    the OPTIMIZATION is what crosses hosts here)."""
    import numpy as np

    from corbslam.optim import ba_dense

    rng = np.random.default_rng(seed)
    t = np.linspace(0, 10.0, n_kf)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    Tcw[:, 2, 3] = -t
    X = np.stack([
        rng.uniform(-8, 8, n_mp), rng.uniform(-2, 2, n_mp),
        rng.uniform(4, 30, n_mp) + np.repeat(
            np.linspace(0, 10.0, n_mp // 64 + 1), 64)[:n_mp],
    ], -1).astype(np.float32)

    obs_mp = np.zeros((n_kf, obs_per_kf), np.int32)
    uvr = np.zeros((3, n_kf, obs_per_kf), np.float32)
    for k in range(n_kf):
        pts = (k * 29 + np.arange(obs_per_kf) * 7) % n_mp
        Xc = X[pts] + np.array([0, 0, -t[k]], np.float32)
        z = np.maximum(Xc[:, 2], 0.5)
        u = cam.fx * Xc[:, 0] / z + cam.cx + rng.normal(0, 0.3, obs_per_kf)
        v = cam.fy * Xc[:, 1] / z + cam.cy + rng.normal(0, 0.3, obs_per_kf)
        obs_mp[k] = pts
        uvr[0, k], uvr[1, k] = u, v
        uvr[2, k] = u - cam.bf / z
    import jax.numpy as jnp

    pose_fixed = np.zeros(n_kf, bool)
    pose_fixed[0] = True
    return ba_dense.BADense(
        Tcw=jnp.asarray(Tcw) , pose_fixed=jnp.asarray(pose_fixed),
        X=jnp.asarray(X + rng.normal(0, 0.05, X.shape).astype(np.float32)),
        point_fixed=jnp.zeros(n_mp, bool),
        obs_mp=jnp.asarray(obs_mp),
        obs_uvr=jnp.asarray(uvr),
        obs_inv_sigma2=jnp.ones((n_kf, obs_per_kf), jnp.float32),
        obs_stereo=jnp.ones((n_kf, obs_per_kf), bool),
        obs_active=jnp.ones((n_kf, obs_per_kf), bool),
    )


def worker(args):
    # Force the CPU backend BEFORE the distributed runtime comes up.
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nprocs,
        process_id=args.proc,
    )
    import numpy as np
    from jax.sharding import Mesh

    from corbslam.geometry import camera
    from corbslam.config import SlamConfig
    from corbslam.parallel import distributed_ba as dba

    cam = camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0)
    cfg = SlamConfig()
    prob = build_problem(cam, cfg)

    devs = np.asarray(jax.devices())  # global device list across processes
    assert len(devs) >= args.nprocs, devs
    mesh = Mesh(devs, (dba.AXIS,))

    # Multi-controller JAX: inputs to a mesh-spanning jit must be GLOBAL
    # arrays — every process contributes its addressable shard. Each
    # process built the identical problem, so the shard callback just
    # slices the local copy (in production the collab transport already
    # delivers per-host map shards).
    from jax.sharding import NamedSharding, PartitionSpec as P

    padded = dba.pad_cameras_dense(prob, len(devs))
    import jax.numpy as jnp
    from corbslam.optim import ba_dense

    specs = ba_dense.BADense(
        Tcw=P(dba.AXIS), pose_fixed=P(dba.AXIS), X=P(), point_fixed=P(),
        obs_mp=P(dba.AXIS), obs_uvr=P(None, dba.AXIS),
        obs_inv_sigma2=P(dba.AXIS), obs_stereo=P(dba.AXIS),
        obs_active=P(dba.AXIS),
    )

    def globalize(leaf, spec):
        arr = np.asarray(leaf)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    gprob = jax.tree.map(globalize, padded, specs,
                         is_leaf=lambda x: isinstance(x, (jnp.ndarray,)))

    opt = dba.make_dense_optimizer(cam, mesh, 8, 24, 2)
    t0 = time.time()
    res = opt(gprob)
    cost = float(res.cost)  # replicated -> addressable everywhere
    dt = time.time() - t0
    # Finiteness of the locally-addressable pose shards.
    local_ok = all(
        bool(np.isfinite(np.asarray(s.data)).all())
        for s in res.Tcw.addressable_shards
    ) and bool(np.isfinite(np.asarray(res.X)).all())
    print(f"[proc {args.proc}] devices={len(devs)} cost={cost:.3f} "
          f"wall={dt:.1f}s finite_local={local_ok}",
          file=sys.stderr, flush=True)
    if args.proc == 0:
        print(json.dumps({
            "n_processes": args.nprocs,
            "n_devices": len(devs),
            "final_cost": round(cost, 3),
            "wall_s": round(dt, 1),
            "finite": bool(local_ok and np.isfinite(cost)),
        }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--proc", type=int, default=-1,
                    help="worker index (internal; launcher spawns workers)")
    ap.add_argument("--coordinator", default="127.0.0.1:19765")
    args = ap.parse_args()

    if args.proc >= 0:
        worker(args)
        return

    procs = []
    for i in range(args.nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__),
             "--nprocs", str(args.nprocs), "--proc", str(i),
             "--coordinator", args.coordinator],
        ))
    rc = 0
    for p in procs:
        rc |= p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
