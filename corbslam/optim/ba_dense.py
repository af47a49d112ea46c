"""Dense-plane bundle adjustment: Schur/PCG LM over [C, Fb] observation
planes — the tile-native layout of the same math as optim/ba.py.

Why a second engine: the flat observation list ([O] with per-obs [3,6]
Jacobians) is the natural CPU layout, but its [O,3,6] temporaries put the
tiny dims last, where device layouts pad them. Here every per-observation
quantity is a PLANE [C, Fb] (camera slot x feature slot), so the big dims
are the minor ones:

  * camera index == row index: Jc^T v and segment-sums over cameras become
    broadcasts / row reductions — no per-observation pose gather at all;
  * Jacobians are 18 + 9 planes [C, Fb] (stacked [3,6,C,Fb] / [3,3,C,Fb]),
    computed symbolically from the projection (the A@B product of
    optim/reproj.py unrolled by hand so no [O,3,3] temp ever exists);
  * point-side reductions are 3-6 scalar segment-sums over the flattened
    [C*Fb] plane.

The observation CAPACITY is also right-sized: problems are built from the
map with a per-keyframe feature budget Fb (valid observations compacted to
the front of each row), not the full [N, F] table, so a 384-KF map costs
384*Fb observations, not N*F = 4.19M.

Same semantics as the reference's g2o SE3+XYZ BA with Huber kernels and
outlier re-classification (ref: corbslam_client/src/Optimizer.cc:54,487,43;
Thirdparty/g2o/g2o/core/block_solver.hpp), same residual-space Schur
product as optim/ba.py (see its docstring for the f32-safety argument).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from . import reproj
from .smallmat import chol_solve_factored, chol_unrolled, inv_spd_unrolled

_PREC = jax.lax.Precision.HIGHEST


class BADense(NamedTuple):
    """BA problem in dense plane layout.

    C camera slots x Fb observation slots per camera. Inactive slots are
    masked by ``obs_active`` (their obs_mp must still be a clipped valid
    index in [0, P)).

    ``pm_src``/``pm_ok`` (optional): the POINT-MAJOR gather table —
    pm_src[p, k] is the flat camera-major index (c * Fb + f) of point p's
    k-th observation. With it, every point-side reduction in the LM loop
    becomes gather + row-sum instead of a segment-sum scatter. On an H100
    the scatter form is the faster one at GBA scale (PERF.md);
    removing the table is ROADMAP C8. Observations past K per point
    are dropped from obs_active at build time so camera- and point-side
    sums stay consistent. Single-device only; the camera-sharded
    distributed path keeps scatter + psum (a point's observations span
    shards there).
    """

    Tcw: jnp.ndarray          # [C, 4, 4]
    pose_fixed: jnp.ndarray   # [C] bool (gauge + frontier + server-fixed)
    X: jnp.ndarray            # [P, 3]
    point_fixed: jnp.ndarray  # [P] bool
    obs_mp: jnp.ndarray       # [C, Fb] i32 point row (clipped)
    obs_uvr: jnp.ndarray      # [3, C, Fb] measured u, v, uR planes
    obs_inv_sigma2: jnp.ndarray  # [C, Fb]
    obs_stereo: jnp.ndarray   # [C, Fb] bool
    obs_active: jnp.ndarray   # [C, Fb] bool
    pm_src: jnp.ndarray | None = None   # [P, K] i32 flat obs index
    pm_ok: jnp.ndarray | None = None    # [P, K] bool


def build_point_major(obs_mp: jnp.ndarray, obs_active: jnp.ndarray,
                      P: int, K: int):
    """Sort-based construction of the point-major gather table.

    Returns (pm_src [P, K], pm_ok [P, K], active' [C, Fb]) where active'
    drops observations beyond K per point (kept consistent on both sides
    of the Schur product). One argsort + searchsorted at problem-build
    time replaces ~every scatter in the LM loop."""
    C, Fb = obs_mp.shape
    O = C * Fb
    ids_flat = jnp.where(obs_active, obs_mp, P).reshape(-1)
    order = jnp.argsort(ids_flat)                      # stable
    sorted_ids = ids_flat[order]
    pts = jnp.arange(P, dtype=sorted_ids.dtype)
    start = jnp.searchsorted(sorted_ids, pts)
    end = jnp.searchsorted(sorted_ids, pts + 1)
    count = end - start
    k = jnp.arange(K, dtype=jnp.int32)
    # Callers size K >= the map's max observations per point (see
    # build_global_problem_dense), so normally nothing is dropped. If a
    # point still overflows, sample its observations at an EVEN stride
    # across its whole (camera-ordered = temporal) span — first-K kept
    # the earliest cameras only, which systematically discarded the
    # late-revisit observations of loop-closure landmarks and bent GBA
    # toward a wrong optimum (r4 loop-e2e bisect: ate_kf 0.19 -> 0.09).
    off_dense = jnp.broadcast_to(k[None, :], (P, K))
    off_strided = (k[None, :] * count[:, None]) // K
    over = (count > K)[:, None]
    off = jnp.where(over, off_strided, off_dense)
    slot = start[:, None] + off
    pm_ok = off < count[:, None]
    pm_src = order[jnp.clip(slot, 0, O - 1)].astype(jnp.int32)
    # Drop non-selected overflow observations from the active mask so
    # camera-side sums see exactly the gathered set.
    keep = jnp.zeros(O + 1, bool).at[
        jnp.where(pm_ok, pm_src, O)
    ].set(True, mode="drop")
    active2 = obs_active & keep[:O].reshape(C, Fb)
    return pm_src, pm_ok, active2


class BADenseResult(NamedTuple):
    Tcw: jnp.ndarray
    X: jnp.ndarray
    inlier: jnp.ndarray  # [C, Fb] final chi2 classification
    cost: jnp.ndarray


class _Lin(NamedTuple):
    r: list               # 3 x [C, F] residual planes
    Jc: list              # 3 x 6 x [C, F] pose-Jacobian planes
    Jp: list              # 3 x 3 x [C, F] point-Jacobian planes
    w3: list              # 3 x [C, F] row weights (0 third row mono)
    depth_ok: jnp.ndarray # [C, F]


def _linearize(cam: cam_mod.Intrinsics, p: BADense) -> _Lin:
    """Residual + Jacobian planes at the current linearization point.

    Symbolic expansion of reproj.linearize's J_pose = -A [I | -hat(p)] and
    J_point = -A R (left-multiplicative se3 update), with A the projection
    differential — every entry a [C, F] plane.

    Planes are nested LISTS, not stacked [3, 6, C, F] tensors: every
    consumer contracts over the tiny leading axes, and expressing those
    contractions as unrolled elementwise ops lets XLA fuse them into the
    plane loops; einsum/dot_general forms over the tiny axes need
    transposes of the whole planes."""
    R = se3.rotation(p.Tcw)          # [C, 3, 3]
    t = se3.translation(p.Tcw)       # [C, 3]
    ids = p.obs_mp                   # [C, F]

    # One packed row-gather ([P,3] rows) reads 12 B per random index where
    # three scalar gathers would read 3 x 4 B.
    Xg_rows = p.X[ids]                                 # [C, F, 3]
    Xg = [Xg_rows[..., j] for j in range(3)]           # 3 x [C, F]
    pc = [
        R[:, i, 0, None] * Xg[0] + R[:, i, 1, None] * Xg[1]
        + R[:, i, 2, None] * Xg[2] + t[:, i, None]
        for i in range(3)
    ]
    x, y, z = pc
    depth_ok = z > 1e-3
    zs = jnp.where(depth_ok, z, 1.0)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    fx, fy, bf = cam.fx, cam.fy, cam.bf
    u = fx * x * inv_z + cam.cx
    v = fy * y * inv_z + cam.cy
    ur = u - bf * inv_z
    r = [p.obs_uvr[0] - u, p.obs_uvr[1] - v, p.obs_uvr[2] - ur]

    # A rows: (a0, 0, a2), (0, b1, b2), (a0, 0, c2).
    a0 = fx * inv_z
    a2 = -fx * x * inv_z2
    b1 = fy * inv_z
    b2 = -fy * y * inv_z2
    c2 = a2 + bf * inv_z2
    zero = jnp.zeros_like(x)

    # J_pose = -(A @ [I | -hat(p)]); -hat(p) = [[0,z,-y],[-z,0,x],[y,-x,0]].
    Jc = [
        [-a0, zero, -a2, -(a2 * y), -(a0 * z - a2 * x), a0 * y],
        [zero, -b1, -b2, -(-b1 * z + b2 * y), b2 * x, -(b1 * x)],
        [-a0, zero, -c2, -(c2 * y), -(a0 * z - c2 * x), a0 * y],
    ]  # 3 x 6 x [C, F]

    # J_point = -(A @ R): row0 = -(a0 R0j + a2 R2j), row1 = -(b1 R1j + b2 R2j),
    # row2 = -(a0 R0j + c2 R2j).
    R0 = [R[:, 0, j, None] for j in range(3)]
    R1 = [R[:, 1, j, None] for j in range(3)]
    R2 = [R[:, 2, j, None] for j in range(3)]
    Jp = [
        [-(a0 * R0[j] + a2 * R2[j]) for j in range(3)],
        [-(b1 * R1[j] + b2 * R2[j]) for j in range(3)],
        [-(a0 * R0[j] + c2 * R2[j]) for j in range(3)],
    ]  # 3 x 3 x [C, F]

    wb = p.obs_inv_sigma2 * depth_ok
    w3 = [wb, wb, jnp.where(p.obs_stereo, wb, 0.0)]
    return _Lin(r, Jc, Jp, w3, depth_ok)


def _chi2(lin: _Lin) -> jnp.ndarray:
    """[C, F] weighted squared error per observation."""
    return sum(lin.r[i] * lin.r[i] * lin.w3[i] for i in range(3))


def _psum(x, axis):
    return jax.lax.psum(x, axis) if axis is not None else x


def _seg3(vals, ids_flat, P, axis=None):
    """Packed 3-component segment sum -> [P, 3]; ids P is the drop bucket.
    One multi-component scatter instead of three scalar ones. Under a
    camera-sharded mesh the local partial sums
    psum into the replicated point state (the "psum of Schur-reduced
    blocks" collective of BASELINE.json)."""
    packed = jnp.stack([v.reshape(-1) for v in vals], axis=-1)  # [CF, 3]
    return _psum(jax.ops.segment_sum(packed, ids_flat, P + 1)[:P], axis)


def lm_step_dense(cam, p: BADense, active, lam, use_huber, cg_iters: int,
                  axis: str | None = None, x0=None, cg_tol: float = 0.03):
    """One LM iteration in plane layout; returns proposed
    (Tcw, X, chi2, delta2, dc).

    `axis`: name of a mesh axis the CAMERA dimension is sharded over
    (shard_map). Point-side reductions and CG scalars psum across it;
    camera-side state stays local — the distributed-GBA layout
    (ref analog: the server's whole-map GlobalBundleAdjustemnt,
    GlobalOptimize.cpp:444, scaled over chips instead of one CPU).

    `x0`: warm start for the reduced-camera CG solve (the previous LM
    iteration's step — consecutive LM systems differ only by the damping
    and the small state move, so the old solution is a strong initial
    guess). `cg_tol`: relative forcing tolerance — CG exits once the
    preconditioned residual norm drops below cg_tol x that of b, so
    converged solves stop paying for the fixed iteration budget (the
    sequential CG scan dominated GBA wall time in r3)."""
    C, P = p.Tcw.shape[0], p.X.shape[0]
    lin = _linearize(cam, p)
    c2 = _chi2(lin)
    delta2 = jnp.where(p.obs_stereo, reproj.CHI2_STEREO, reproj.CHI2_MONO)
    rw = jnp.where(use_huber, reproj.huber_weights(c2, delta2), 1.0)
    act_f = active.astype(jnp.float32)

    Jc, Jp, r = lin.Jc, lin.Jp, lin.r
    w = [lin.w3[i] * (rw * act_f) for i in range(3)]   # 3 x [C, F]
    Jc_w = [[Jc[i][j] * w[i] for j in range(6)] for i in range(3)]
    Jp_w = [[Jp[i][j] * w[i] for j in range(3)] for i in range(3)]
    free_c = (~p.pose_fixed).astype(jnp.float32)
    free_p = (~p.point_fixed).astype(jnp.float32)
    ids_flat = jnp.where(active, p.obs_mp, P).reshape(-1)

    # Point-side reduction: gather + row-sum through the point-major table
    # when available (single device), segment-sum scatter + psum otherwise
    # (camera-sharded distributed path). See BADense.pm_src for why.
    use_pm = axis is None and p.pm_src is not None

    def seg_multi(vals):
        """list of [C, F] planes -> [P, len(vals)] summed per point."""
        if use_pm:
            flat = jnp.stack([v.reshape(-1) for v in vals], 0)  # [n, O]
            g = jnp.where(p.pm_ok[None], flat[:, p.pm_src], 0.0)
            return jnp.sum(g, axis=-1).T                        # [P, n]
        packed = jnp.stack([v.reshape(-1) for v in vals], axis=-1)
        return _psum(jax.ops.segment_sum(packed, ids_flat, P + 1)[:P], axis)

    # Point Hessians [P, 3, 3]: 6 symmetric entries in ONE reduction.
    sym = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    hp = seg_multi([
        sum(Jp_w[rr][i] * Jp[rr][j] for rr in range(3)) for i, j in sym
    ])
    e = {s: hp[:, k] for k, s in enumerate(sym)}
    Hpp = jnp.stack([
        jnp.stack([e[(min(i, j), max(i, j))] for j in range(3)], -1)
        for i in range(3)
    ], -2)  # [P, 3, 3]

    # Camera diagonal blocks [C, 6, 6]: unrolled row reductions over F
    # (21 unique entries x 3 residual rows; elementwise).
    hcc = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i, 6):
            hcc[i][j] = sum(
                jnp.sum(Jc_w[rr][i] * Jc[rr][j], axis=-1) for rr in range(3)
            )
            hcc[j][i] = hcc[i][j]
    Hcc = jnp.stack(
        [jnp.stack([hcc[i][j] for j in range(6)], -1) for i in range(6)], -2
    )  # [C, 6, 6]

    hpp_diag = jnp.stack([e[(i, i)] for i in range(3)], -1)    # [P, 3]
    hcc_diag = jnp.stack([hcc[i][i] for i in range(6)], -1)    # [C, 6]
    Hpp_d = Hpp + (lam * hpp_diag + 1e-6)[..., None] * jnp.eye(3)
    Lpp = chol_unrolled(Hpp_d, 3)

    def point_solve(yv):  # [P, 3] -> Hpp_d^-1 y; fixed points give 0
        return chol_solve_factored(Lpp, yv, 3) * free_p[:, None]

    def jc_dot(vc):
        """[C, 6] -> a[r] = Jc v planes, 3 x [C, F] (camera idx == row)."""
        return [
            sum(Jc[rr][j] * vc[:, j, None] for j in range(6))
            for rr in range(3)
        ]

    def jp_dot(zp):
        """[P, 3] -> Jp z planes 3 x [C, F] (one packed row gather)."""
        zg_rows = zp[p.obs_mp]                          # [C, F, 3]
        return [
            sum(Jp[rr][j] * zg_rows[..., j] for j in range(3))
            for rr in range(3)
        ]

    def jcw_T(m3):
        """3 x [C, F] planes -> [C, 6]: sum_r sum_f Jc_w[r][j] * m3[r]."""
        return jnp.stack([
            sum(jnp.sum(Jc_w[rr][j] * m3[rr], axis=-1) for rr in range(3))
            for j in range(6)
        ], -1)

    def schur_mv(vc):
        """S v in residual space; fixed cameras projected out."""
        vc = vc * free_c[:, None]
        a = jc_dot(vc)                                  # 3 x [C, F]
        yv = seg_multi([
            sum(Jp_w[rr][i] * a[rr] for rr in range(3)) for i in range(3)
        ])
        zp = point_solve(yv)
        jz = jp_dot(zp)
        Sv = jcw_T([a[rr] - jz[rr] for rr in range(3)])
        Sv = Sv + (lam * hcc_diag + 1e-8) * vc
        return Sv * free_c[:, None]

    # RHS: b = -sum Jc^T w (r - Jp z_g), z_g = Hpp_d^-1 (Jp^T w r).
    gp = seg_multi([
        sum(Jp_w[rr][i] * r[rr] for rr in range(3)) for i in range(3)
    ])
    z_g = point_solve(gp)
    jzg = jp_dot(z_g)
    b = -jcw_T([r[rr] - jzg[rr] for rr in range(3)]) * free_c[:, None]

    # Block-Jacobi preconditioner from damped camera blocks.
    Hcc_d = Hcc + (lam * hcc_diag + 1e-8)[..., None] * jnp.eye(6)
    Minv = inv_spd_unrolled(Hcc_d, 6)

    def precond(rv):
        """[C, 6] -> Minv rv, unrolled 6x6 (36 small [C] ops)."""
        out = jnp.stack([
            sum(Minv[:, i, j] * rv[:, j] for j in range(6)) for i in range(6)
        ], -1)
        return out * free_c[:, None]

    # Forcing threshold from b itself (not the warm-started residual, which
    # may already be small): solve to ||r||_Minv <= cg_tol * ||b||_Minv.
    bz = _psum(jnp.sum(b * precond(b)), axis)
    threshold = (cg_tol * cg_tol) * bz

    if x0 is None:
        xs = jnp.zeros_like(b)
        r0 = b
    else:
        # Scaled warm start: xs = alpha * x0 with alpha minimizing
        # ||b - alpha A x0||, so the start is never worse than cold
        # (alpha -> 0 when the previous direction is useless). One extra
        # matvec, typically saves several.
        xd = x0 * free_c[:, None]
        Ad = schur_mv(xd)
        alpha = (_psum(jnp.sum(b * Ad), axis)
                 / jnp.maximum(_psum(jnp.sum(Ad * Ad), axis), 1e-20))
        xs = alpha * xd
        r0 = b - alpha * Ad
    z0 = precond(r0)
    rz0 = _psum(jnp.sum(r0 * z0), axis)

    def cg_cond(state):
        _, _, _, rz, k = state
        return (k < cg_iters) & (rz > threshold)

    def cg_body(state):
        xv, rv, pdir, rz, k = state
        Ap = schur_mv(pdir)
        pAp = _psum(jnp.sum(pdir * Ap), axis)
        alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
        xv = xv + alpha * pdir
        rv = rv - alpha * Ap
        zz = precond(rv)
        rz_new = _psum(jnp.sum(rv * zz), axis)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        return (xv, rv, zz + beta * pdir, rz_new, k + 1)

    dc, _, _, _, _ = jax.lax.while_loop(
        cg_cond, cg_body, (xs, r0, z0, rz0, jnp.int32(0)))

    # Back-substitute: dp = -Hpp_d^-1 Jp^T w (r + Jc dc).
    jd = jc_dot(dc)
    y2 = seg_multi([
        sum(Jp_w[rr][i] * (r[rr] + jd[rr]) for rr in range(3))
        for i in range(3)
    ])
    dp = -point_solve(y2)

    T_new = se3.retract(p.Tcw, dc)
    T_new = jnp.where(p.pose_fixed[:, None, None], p.Tcw, T_new)
    return T_new, p.X + dp, c2, delta2, dc


def _total_cost(c2, delta2, act_f, use_huber):
    rho = jnp.where(
        use_huber & (c2 > delta2),
        2.0 * jnp.sqrt(delta2 * jnp.maximum(c2, 1e-12)) - delta2,
        c2,
    )
    return jnp.sum(rho * act_f)


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "huber_iters"))
def optimize(
    cam: cam_mod.Intrinsics,
    problem: BADense,
    n_iters: int = 10,
    cg_iters: int = 40,
    huber_iters: int = 5,
) -> BADenseResult:
    """LM loop with accept/reject; same schedule as optim/ba.optimize
    (robust phase then plain, outlier re-classification after the robust
    phase — Optimizer.cc:711-758)."""
    return optimize_core(cam, problem, n_iters, cg_iters, huber_iters, None)


def optimize_core(
    cam: cam_mod.Intrinsics,
    problem: BADense,
    n_iters: int,
    cg_iters: int,
    huber_iters: int,
    axis: str | None,
) -> BADenseResult:
    """The LM loop body, callable single-device (axis=None) or INSIDE a
    shard_map with the camera dimension split over `axis` (the accept /
    reject decision then uses the psum'd global cost, so every shard takes
    identical branches — see parallel/distributed_ba.optimize_dense)."""

    def chi2_of(p):
        lin = _linearize(cam, p)
        return _chi2(lin)

    def body(state, it):
        p, lam, active, dc_prev = state
        use_huber = it < huber_iters
        T_new, X_new, c2_old, delta2, dc = lm_step_dense(
            cam, p, active, lam, use_huber, cg_iters, axis, x0=dc_prev)
        p_new = p._replace(Tcw=T_new, X=X_new)
        c2_new = chi2_of(p_new)
        act_f = active.astype(jnp.float32)
        cost_new = _psum(_total_cost(c2_new, delta2, act_f, use_huber), axis)
        cost_old = _psum(_total_cost(c2_old, delta2, act_f, use_huber), axis)
        accept = cost_new < cost_old
        p = jax.tree.map(
            lambda a, b: jnp.where(jnp.reshape(accept, (1,) * a.ndim), a, b),
            p_new, p,
        )
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 5.0, 1e3))
        # chi2 at the accepted state (no third linearize needed).
        c2_cur = jnp.where(accept, c2_new, c2_old)
        reclass = active & (c2_cur <= delta2)
        active = jnp.where(it == huber_iters - 1, reclass, active)
        return (p, lam, active, dc), cost_old

    active0 = problem.obs_active
    dc0 = jnp.zeros((problem.Tcw.shape[0], 6), problem.Tcw.dtype)
    (p, _, active, _), _ = jax.lax.scan(
        body, (problem, jnp.float32(1e-4), active0, dc0), jnp.arange(n_iters)
    )

    c2 = chi2_of(p)
    delta2 = jnp.where(p.obs_stereo, reproj.CHI2_STEREO, reproj.CHI2_MONO)
    inlier = problem.obs_active & (c2 <= delta2)
    cost = _psum(_total_cost(c2, delta2, active.astype(jnp.float32), False),
                 axis)
    # Rotations re-enter the stored map: renormalize (se3.orthonormalize_fast
    # docstring explains the exponential-compounding failure otherwise).
    return BADenseResult(se3.orthonormalize_fast(p.Tcw), p.X, inlier, cost)


# ---------------------------------------------------------------------------
# Problem builders
# ---------------------------------------------------------------------------

def _inv_sigma2_of(octave, scale_factor: float):
    return 1.0 / (scale_factor ** (2.0 * octave.astype(jnp.float32)))


def compact_rows(ok: jnp.ndarray, budget: int) -> jnp.ndarray:
    """Per-row compaction: [N, F] validity -> [N, budget] column indices with
    valid entries first (stable order). Rows with fewer than `budget` valid
    entries point the tail at invalid columns (caller re-checks ok)."""
    order = jnp.argsort(~ok, axis=1, stable=True)
    return order[:, :budget]


def problem_from_map(
    m, scale_factor: float, obs_per_kf: int, gauge_row: int = 0,
    pm_k: int | None = 24,
) -> BADense:
    """Flatten the full map into a BADense with a per-keyframe observation
    budget — the right-sized global-BA problem (GlobalBundleAdjustemnt's
    all-KFs/all-points graph, ref Optimizer.cc:43-54) that made the
    capacity-sized [N*F] flattening OOM-proof. `pm_k` caps observations
    per point for the point-major gather table (overflow observations are
    dropped; well-observed points lose only their weakest redundancy).
    `pm_k=None` skips the table AND its thinning entirely — the camera-
    sharded distributed path keeps scatter+psum and must not lose
    observations to a table it discards (advisor r4)."""
    idx = m.kf.mp_idx
    ok = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    ok &= jnp.where(idx >= 0, m.mp.valid[jnp.clip(idx, 0)], False)

    sel = compact_rows(ok, obs_per_kf)                        # [N, Fb]
    take = lambda a: jnp.take_along_axis(a, sel, axis=1)
    active = take(ok)
    ids = jnp.clip(take(idx), 0)
    u = take(m.kf.xy[..., 0])
    v = take(m.kf.xy[..., 1])
    ur = take(m.kf.uright)
    inv_sigma2 = _inv_sigma2_of(take(m.kf.octave), scale_factor)

    P = m.mp.pos.shape[0]
    if pm_k is None:
        pm_src = pm_ok = None
    else:
        pm_src, pm_ok, active = build_point_major(ids, active, P, pm_k)

    pose_fixed = ~m.kf.valid | m.kf.fixed
    pose_fixed = pose_fixed.at[gauge_row].set(True)
    return BADense(
        Tcw=m.kf.Tcw,
        pose_fixed=pose_fixed,
        X=m.mp.pos,
        point_fixed=~m.mp.valid | m.mp.fixed,
        obs_mp=ids,
        obs_uvr=jnp.stack([u, v, ur]),
        obs_inv_sigma2=inv_sigma2,
        obs_stereo=ur > 0,
        obs_active=active,
        pm_src=pm_src,
        pm_ok=pm_ok,
    )


def slice_problem(p: BADense, Cr: int, Pr: int) -> BADense:
    """Right-size a capacity-shaped problem to its USED rows (rounded-up
    static shapes): every plane, gather, and reduction in the LM loop
    scales with C x Fb and P, so running a 768-keyframe map at the
    2048-row capacity pays 2.7x on everything. Active observations only
    reference cameras < n_kf and points < n_mp, so slicing is lossless;
    pm table entries for dropped rows vanish with the rows."""
    t = lambda a: a[:Cr]
    return p._replace(
        Tcw=t(p.Tcw), pose_fixed=t(p.pose_fixed),
        X=p.X[:Pr], point_fixed=p.point_fixed[:Pr],
        obs_mp=jnp.minimum(t(p.obs_mp), Pr - 1),
        obs_uvr=p.obs_uvr[:, :Cr],
        obs_inv_sigma2=t(p.obs_inv_sigma2), obs_stereo=t(p.obs_stereo),
        obs_active=t(p.obs_active),
        pm_src=None if p.pm_src is None else p.pm_src[:Pr],
        pm_ok=None if p.pm_ok is None else p.pm_ok[:Pr],
    )


def round_up(n: int, step: int, cap: int) -> int:
    return min(cap, max(step, ((n + step - 1) // step) * step))


def problem_from_window(m, sel, scale_factor: float) -> BADense:
    """Local-BA window (LocalBAInputs) -> BADense. Camera slot = window
    slot; the window's [W, F] feature table IS the plane layout, so no
    per-row compaction is needed (W is small). Point rows are compacted to
    sel.mp_rows with an inverse map, as optim/ba's flat builder did."""
    W = sel.kf_rows.shape[0]
    P = sel.mp_rows.shape[0]

    inv = jnp.full(m.mp.capacity, -1, jnp.int32)
    inv = inv.at[sel.mp_rows].set(
        jnp.where(sel.mp_ok, jnp.arange(P, dtype=jnp.int32), -1)
    )
    idx = m.kf.mp_idx[sel.kf_rows]                            # [W, F]
    ok = (idx >= 0) & m.kf.fvalid[sel.kf_rows] & sel.kf_ok[:, None]
    compact = jnp.where(ok, inv[jnp.clip(idx, 0)], -1)
    ok &= compact >= 0

    u = m.kf.xy[sel.kf_rows, :, 0]
    v = m.kf.xy[sel.kf_rows, :, 1]
    ur = m.kf.uright[sel.kf_rows]
    inv_sigma2 = _inv_sigma2_of(m.kf.octave[sel.kf_rows], scale_factor)

    # A window point is observed by at most W cameras, so K = W loses
    # nothing.
    pm_src, pm_ok, ok = build_point_major(jnp.clip(compact, 0), ok, P, W)

    return BADense(
        Tcw=m.kf.Tcw[sel.kf_rows],
        pose_fixed=~(sel.kf_free & sel.kf_ok),
        X=m.mp.pos[sel.mp_rows],
        point_fixed=~sel.mp_ok | m.mp.fixed[sel.mp_rows],
        obs_mp=jnp.clip(compact, 0),
        obs_uvr=jnp.stack([u, v, ur]),
        obs_inv_sigma2=inv_sigma2,
        obs_stereo=ur > 0,
        obs_active=ok,
        pm_src=pm_src,
        pm_ok=pm_ok,
    )
