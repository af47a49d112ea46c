"""Distributed bundle adjustment over a device mesh.

The multi-device form of the reference's server-side global BA
(`Optimizer::GlobalBundleAdjustemnt` driven by `GlobalOptimize`, ref:
corbslam_server/src/GlobalOptimize.cpp:435, Optimizer.cc:43): the
observation list shards across devices (each device linearizes its own
observations), poses and points stay replicated, and every reduction in the
Schur/PCG pipeline becomes a `psum` over the mesh axis — the "psum of
Schur-reduced camera blocks" design named in BASELINE.json. The mesh is
1-D: every GPU of a host reaches every other over NVLink at the same rate,
so no device topology shapes it.

Built with `jax.shard_map` so the collectives are explicit:
  per-device:  J = linearize(local obs)
               Hpp_local, g_local = segment_sum(J ...)
  collective:  Hpp = psum(Hpp_local), ...
  CG matvec:   local two-pass segment product + psum
Cost per CG iteration: O(O/n_devices) compute + two [C,6]/[P,3] psums — the
camera/point state is tiny next to the observation set, so scaling is
observation-parallel like data-parallel training.

Multi-host deployment (SURVEY.md §5.8 / P7): nothing here is single-host —
the mesh is whatever `jax.devices()` exposes. Across hosts, initialize the
runtime with `jax.distributed.initialize()` on every host and build the
mesh over the global device list; the same shard_map then runs its psums
across hosts, with XLA choosing the collective implementation. The CONTROL plane (client<->server delta sync)
is transport-pluggable: socket_transport (TCP) already works across hosts,
shm_transport covers same-host fleets, and the fusion server is agnostic to
which one carries its calls. Exercised hermetically on the 8-device CPU
mesh by tests/test_parallel.py and __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..optim import ba, ba_dense, reproj
from ..optim.smallmat import chol_solve_factored, chol_unrolled, inv_spd_unrolled

_PREC = jax.lax.Precision.HIGHEST
AXIS = "shard"


def pad_observations(problem: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the observation list so it divides the mesh; padding is invalid."""
    O = problem.obs_cam.shape[0]
    pad = (-O) % multiple
    if pad == 0:
        return problem
    z = lambda a, fill=0: jnp.concatenate(
        [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
    )
    return problem._replace(
        obs_cam=z(problem.obs_cam),
        obs_point=z(problem.obs_point),
        obs_uvr=z(problem.obs_uvr),
        obs_inv_sigma2=z(problem.obs_inv_sigma2),
        obs_stereo=z(problem.obs_stereo, False),
        obs_valid=z(problem.obs_valid, False),
    )


def make_gn_step(cam: cam_mod.Intrinsics, mesh: Mesh, cg_iters: int = 50):
    """Builds a sharded Gauss-Newton/LM step function.

    Returned fn: (Tcw [C,4,4], X [P,3], pose_fixed, point_fixed,
    obs_* sharded arrays, lam) -> (Tcw', X'). Observations sharded over
    AXIS; all small state replicated.
    """

    def gn_step(Tcw, X, pose_fixed, point_fixed,
                obs_cam, obs_point, obs_uvr, obs_inv_sigma2, obs_stereo,
                obs_valid, lam):
        C, Pn = Tcw.shape[0], X.shape[0]
        res = reproj.linearize(
            cam, Tcw[obs_cam], X[obs_point], obs_uvr, obs_inv_sigma2, obs_stereo
        )
        c2 = reproj.chi2(res.r, res.w)
        delta2 = reproj.chi2_threshold(obs_stereo)
        rw = reproj.huber_weights(c2, delta2)
        act = (obs_valid & res.depth_ok).astype(jnp.float32)
        Jc, Jp = res.J_pose, res.J_point
        w = res.w * (rw * act)[:, None]
        Jc_w = Jc * w[:, :, None]
        Jp_w = Jp * w[:, :, None]
        free_c = (~pose_fixed).astype(jnp.float32)
        free_p = (~point_fixed).astype(jnp.float32)

        def seg_p(v):  # [O_local, 3] -> [P, 3] global (psum)
            return jax.lax.psum(jax.ops.segment_sum(v, obs_point, Pn), AXIS)

        def seg_c(v):  # [O_local, 6] -> [C, 6] global (psum)
            return jax.lax.psum(jax.ops.segment_sum(v, obs_cam, C), AXIS)

        Hpp = jax.lax.psum(
            jax.ops.segment_sum(
                jnp.einsum("ori,orj->oij", Jp_w, Jp, precision=_PREC), obs_point, Pn
            ),
            AXIS,
        )
        Hcc = jax.lax.psum(
            jax.ops.segment_sum(
                jnp.einsum("ori,orj->oij", Jc_w, Jc, precision=_PREC), obs_cam, C
            ),
            AXIS,
        )
        hpp_diag = jnp.einsum("pii->pi", Hpp)
        hcc_diag = jnp.einsum("cii->ci", Hcc)
        Hpp_d = Hpp + (lam * hpp_diag + 1e-6)[..., None] * jnp.eye(3)
        Lpp = chol_unrolled(Hpp_d, 3)

        def point_solve(y):
            return chol_solve_factored(Lpp, y, 3) * free_p[:, None]

        def schur_mv(v):
            v = v * free_c[:, None]
            a = jnp.einsum("orj,oj->or", Jc, v[obs_cam], precision=_PREC)
            y = seg_p(jnp.einsum("ori,or->oi", Jp_w, a, precision=_PREC))
            z = point_solve(y)
            mres = a - jnp.einsum("orj,oj->or", Jp, z[obs_point], precision=_PREC)
            Sv = seg_c(jnp.einsum("ori,or->oi", Jc_w, mres, precision=_PREC))
            Sv = Sv + (lam * hcc_diag + 1e-8) * v
            return Sv * free_c[:, None]

        gp_pos = seg_p(jnp.einsum("ori,or->oi", Jp_w, res.r, precision=_PREC))
        z_g = point_solve(gp_pos)
        m_b = res.r - jnp.einsum("orj,oj->or", Jp, z_g[obs_point], precision=_PREC)
        b = -seg_c(jnp.einsum("ori,or->oi", Jc_w, m_b, precision=_PREC)) * free_c[:, None]

        Hcc_dm = Hcc + (lam * hcc_diag + 1e-8)[..., None] * jnp.eye(6)
        Minv = inv_spd_unrolled(Hcc_dm, 6)

        def precond(r):
            return jnp.einsum("cij,cj->ci", Minv, r, precision=_PREC) * free_c[:, None]

        x = jnp.zeros_like(b)
        r0 = b
        z0 = precond(r0)
        rz0 = jnp.sum(r0 * z0)

        def cg_body(state, _):
            x, r, pdir, rz = state
            Ap = schur_mv(pdir)
            pAp = jnp.sum(pdir * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
            x = x + alpha * pdir
            r = r - alpha * Ap
            zz = precond(r)
            rz_new = jnp.sum(r * zz)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            return (x, r, zz + beta * pdir, rz_new), None

        (dc, _, _, _), _ = jax.lax.scan(cg_body, (x, r0, z0, rz0), None, length=cg_iters)

        a_dc = jnp.einsum("orj,oj->or", Jc, dc[obs_cam], precision=_PREC)
        y2 = seg_p(jnp.einsum("ori,or->oi", Jp_w, res.r + a_dc, precision=_PREC))
        dp = -point_solve(y2)

        T_new = se3.retract(Tcw, dc)
        T_new = jnp.where(pose_fixed[:, None, None], Tcw, T_new)
        return T_new, X + dp

    rep = P()
    sh = P(AXIS)
    sharded = jax.shard_map(
        gn_step,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, sh, sh, sh, sh, sh, sh, rep),
        out_specs=(rep, rep),
        check_vma=False,
    )
    return jax.jit(sharded)


def distributed_ba(
    cam: cam_mod.Intrinsics,
    problem: ba.BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    cg_iters: int = 50,
    lam: float = 1e-4,
):
    """Run n_iters sharded GN/LM steps (fixed damping) on the mesh.

    The replicated-state/sharded-observation layout: put the obs arrays on
    the mesh with NamedSharding so each chip holds 1/n of the observations.
    """
    n_dev = mesh.devices.size
    problem = pad_observations(problem, n_dev)
    step = make_gn_step(cam, mesh, cg_iters)

    obs_sharding = NamedSharding(mesh, P(AXIS))
    rep_sharding = NamedSharding(mesh, P())
    put = lambda a, s: jax.device_put(a, s)
    Tcw = put(problem.Tcw, rep_sharding)
    X = put(problem.X, rep_sharding)
    pf = put(problem.pose_fixed, rep_sharding)
    ptf = put(problem.point_fixed, rep_sharding)
    oc = put(problem.obs_cam, obs_sharding)
    op = put(problem.obs_point, obs_sharding)
    uvr = put(problem.obs_uvr, obs_sharding)
    isig = put(problem.obs_inv_sigma2, obs_sharding)
    ost = put(problem.obs_stereo, obs_sharding)
    ov = put(problem.obs_valid, obs_sharding)

    for _ in range(n_iters):
        Tcw, X = step(Tcw, X, pf, ptf, oc, op, uvr, isig, ost, ov, jnp.float32(lam))
    return Tcw, X


# ---------------------------------------------------------------------------
# Dense-plane distributed BA (the production GBA path, camera-sharded)
# ---------------------------------------------------------------------------

def pad_cameras_dense(p: ba_dense.BADense, multiple: int) -> ba_dense.BADense:
    """Pad the camera axis so it divides the mesh; padding rows are fixed
    and inactive."""
    C = p.Tcw.shape[0]
    pad = (-C) % multiple
    if pad == 0:
        return p
    padT = jnp.tile(jnp.eye(4, dtype=p.Tcw.dtype), (pad, 1, 1))
    z = lambda a, fill=0: jnp.concatenate(
        [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
    )
    return p._replace(
        Tcw=jnp.concatenate([p.Tcw, padT]),
        pose_fixed=z(p.pose_fixed, True),
        obs_mp=z(p.obs_mp),
        obs_uvr=jnp.concatenate(
            [p.obs_uvr, jnp.zeros((3, pad) + p.obs_uvr.shape[2:],
                                  p.obs_uvr.dtype)], axis=1),
        obs_inv_sigma2=z(p.obs_inv_sigma2),
        obs_stereo=z(p.obs_stereo, False),
        obs_active=z(p.obs_active, False),
    )


@lru_cache(maxsize=32)
def make_dense_optimizer(cam: cam_mod.Intrinsics, mesh: Mesh,
                         n_iters: int, cg_iters: int, huber_iters: int):
    """Jitted shard_map program running ba_dense's FULL LM loop (accept/
    reject included) with the camera dimension split over the mesh: each
    device linearizes its own keyframe rows; point-side Schur reductions and
    CG scalars psum over the mesh (the BASELINE.json "psum of Schur-reduced
    camera blocks" north star, now on the production engine the server's
    GlobalBARunner dispatches — ref analog GlobalOptimize.cpp:444)."""

    def run(p: ba_dense.BADense) -> ba_dense.BADenseResult:
        return ba_dense.optimize_core(
            cam, p, n_iters, cg_iters, huber_iters, AXIS)

    shard = P(AXIS)
    rep = P()
    in_specs = (ba_dense.BADense(
        Tcw=shard, pose_fixed=shard, X=rep, point_fixed=rep,
        obs_mp=shard, obs_uvr=P(None, AXIS), obs_inv_sigma2=shard,
        obs_stereo=shard, obs_active=shard,
    ),)
    out_specs = ba_dense.BADenseResult(
        Tcw=shard, X=rep, inlier=shard, cost=rep)
    return jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    ))


def optimize_dense(
    cam: cam_mod.Intrinsics,
    problem: ba_dense.BADense,
    mesh: Mesh,
    n_iters: int = 10,
    cg_iters: int = 20,
    huber_iters: int = 3,
) -> ba_dense.BADenseResult:
    """Distributed dense-plane BA: shard cameras over the mesh, run the
    full LM loop, return a result with the padding stripped."""
    C = problem.Tcw.shape[0]
    n_dev = mesh.devices.size
    # The point-major gather table is single-device only (a point's
    # observations span camera shards here) — drop it; the sharded loop
    # uses segment-sum + psum.
    problem = problem._replace(pm_src=None, pm_ok=None)
    padded = pad_cameras_dense(problem, n_dev)
    opt = make_dense_optimizer(cam, mesh, n_iters, cg_iters, huber_iters)

    shard = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    put = ba_dense.BADense(
        Tcw=jax.device_put(padded.Tcw, shard),
        pose_fixed=jax.device_put(padded.pose_fixed, shard),
        X=jax.device_put(padded.X, rep),
        point_fixed=jax.device_put(padded.point_fixed, rep),
        obs_mp=jax.device_put(padded.obs_mp, shard),
        obs_uvr=jax.device_put(padded.obs_uvr, NamedSharding(mesh, P(None, AXIS))),
        obs_inv_sigma2=jax.device_put(padded.obs_inv_sigma2, shard),
        obs_stereo=jax.device_put(padded.obs_stereo, shard),
        obs_active=jax.device_put(padded.obs_active, shard),
    )
    res = opt(put)
    return ba_dense.BADenseResult(
        Tcw=res.Tcw[:C], X=res.X, inlier=res.inlier[:C], cost=res.cost)
