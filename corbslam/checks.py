"""End-to-end checks shared by `chip_smoke.py`, `bench.py`, the chip-marked
tests and `tools/loop_e2e.py`.

Each check builds its own seeded workload, runs it through the package's
normal entry points on the default device, asserts what a correct result
looks like, and returns a dict of what it measured. None of them chooses a
device: the caller decides where JAX runs.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .config import CapacityConfig, MappingConfig, OrbConfig, SlamConfig, TrackingConfig
from .geometry import camera, se3
from .io import synthetic, trajectory

Log = Callable[[str], None]


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require_gpu(devices) -> None:
    """Refuse any device list whose first device is not a GPU: timings and
    on-card checks never fall back to the CPU."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SystemExit(f"no GPU found (JAX platform: {kind})")


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


class CompileCounter:
    """Counts backend compilations (and their seconds) as JAX reports them."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.n, self.secs = 0, 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.n += 1
            self.secs += duration


KITTI_CAM = camera.Intrinsics.create(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
    width=1241, height=376,
)

# Rig and config of the closed-orbit loop check (those of
# tests/test_loop_e2e.py): a 320x240 stereo rig orbiting inside a textured
# room.
ORBIT_CAM = camera.Intrinsics.create(
    fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5,
    width=320, height=240,
)
ORBIT_CFG = SlamConfig(
    orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
    tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
    mapping=MappingConfig(local_ba_window=8, local_ba_iters=6),
    capacity=CapacityConfig(
        max_keyframes=256, max_map_points=32768, max_features=512,
        local_window_kfs=8, local_window_mps=2048,
    ),
)


def planar_world(cam):
    """bench.py's textured plane and its forward-drifting stereo path."""
    world = synthetic.PlanarWorld(cam, texture_size=4096, plane_dist=12.0,
                                  texture_scale=60.0, seed=0)
    tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))

    def gt_pose(i):
        xi = jnp.asarray([-(i * 0.3), 0.0, -(i * 0.05), 0.0, i * 0.002, 0.0],
                         jnp.float32)
        return se3.compose(tilt, se3.exp(xi))

    return world, gt_pose


def window_ate(traj, gt_pose) -> float:
    """Aligned ATE of a tracker trajectory [(t, Tcw)] against gt_pose(i)."""
    est = np.asarray([np.linalg.inv(np.asarray(T)) for _, T in traj])
    gtw = np.asarray([np.linalg.inv(np.asarray(gt_pose(i)))
                      for i in range(len(est))])
    return float(trajectory.ate_rmse(est, gtw, align=True))


# ---------------------------------------------------------------------------
# Front end: the card against the CPU backend and the NumPy references
# ---------------------------------------------------------------------------

# Largest absolute difference allowed between two backends' pyramid levels
# (0-255 scale): the bilinear lerps and blur taps round differently when a
# backend contracts a multiply-add into one fused instruction.
LEVEL_TOL = 1e-3


def _np_brief_bits(blur_levels, octave, yx, bins):
    """NumPy steered-BRIEF over zero-padded blurred levels: the samples
    (a, b) of every pair and the bits a < b, per keypoint."""
    from .ops import brief, patches

    tab = brief.brief_table()
    P = patches.PAD
    padded = [np.pad(np.asarray(b, np.float32), P) for b in blur_levels]
    K = len(octave)
    a = np.zeros((K, 256), np.float32)
    b = np.zeros((K, 256), np.float32)
    for k in range(K):
        img = padded[octave[k]]
        t = tab[bins[k]]                            # [256, 2, 2]
        ys = yx[k, 0] + P + t[..., 0]
        xs = yx[k, 1] + P + t[..., 1]
        s = img[ys, xs]
        a[k], b[k] = s[:, 0], s[:, 1]
    return a, b, a < b


def _np_hamming(a, b):
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x, axis=-1).sum(-1)


def frontend_agreement(cam, cfg: OrbConfig, voc=None,
                       log: Log = print) -> dict:
    """Phase 1 of chip_smoke: ORB extraction, stereo matching, Hamming and
    vocabulary assignment on the default device against the same code on
    the CPU backend, with the NumPy gather references as ground truth."""
    from .ops import brief, descriptors as D, orb, pyramid, stereo
    from .place import vocab as vocab_mod

    cpu = jax.devices("cpu")[0]
    world, gt_pose = planar_world(cam)
    l, r = jax.jit(lambda T: world.render_stereo(T))(gt_pose(3))
    to_cpu = lambda x: jax.device_put(x, cpu)
    out = {}

    pyr = jax.jit(lambda im: pyramid.build_pyramid(
        im, cfg.n_levels, cfg.scale_factor))
    lv_d, bl_d = pyr(l)
    lv_c, bl_c = pyr(to_cpu(l))
    lvl_diff = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(lv_d + bl_d, lv_c + bl_c))
    out["pyramid_max_abs_diff"] = lvl_diff
    assert lvl_diff <= LEVEL_TOL, lvl_diff

    ext = jax.jit(lambda im: orb.extract(im, cfg))
    fd = jax.tree.map(np.asarray, ext(l))
    fc = jax.tree.map(np.asarray, ext(to_cpu(l)))
    for k in ("xy", "octave", "valid"):
        assert (fd._asdict()[k] == fc._asdict()[k]).all(), f"keypoint {k}"
    bin_d = np.asarray(brief.angle_bin(jnp.asarray(fd.angle)))
    bin_c = np.asarray(brief.angle_bin(jnp.asarray(fc.angle)))
    assert (bin_d == bin_c).all(), "angle bins"
    out["n_keypoints"] = int(fc.valid.sum())

    # BRIEF against the NumPy reference built from the CPU blurred levels.
    scales = np.asarray(cfg.scales(), np.float32)
    yx = np.rint(fc.xy[:, ::-1] / scales[fc.octave][:, None]).astype(np.int64)
    sa, sb, ref_bits = _np_brief_bits(bl_c, fc.octave, yx, bin_c)
    ref_bits &= fc.valid[:, None]
    unpack = lambda d: np.unpackbits(d, axis=-1, bitorder="little").astype(bool)
    bits_c, bits_d = unpack(fc.desc), unpack(fd.desc)
    valid = fc.valid[:, None]
    assert ((bits_c == ref_bits) | ~valid).all(), "CPU BRIEF != NumPy reference"
    differ = (bits_d != ref_bits) & valid
    near_tie = np.abs(sa - sb) < LEVEL_TOL
    assert not (differ & ~near_tie).any(), "device BRIEF bit off a near tie"
    out["brief_bits_differing_near_ties"] = int(differ.sum())
    out["brief_pairs_near_tie"] = int((near_tie & valid).sum())

    # Integer results on identical inputs must be identical.
    ham = jax.jit(D.hamming_matrix)
    ref = _np_hamming(fc.desc, fc.desc[::-1])
    for dev in (None, cpu):
        put = (lambda x: x) if dev is None else to_cpu
        got = np.asarray(ham(put(jnp.asarray(fc.desc)),
                             put(jnp.asarray(fc.desc[::-1]))))
        assert (got == ref).all(), f"hamming on {dev or 'device'}"
    if voc is not None:
        assign = jax.jit(lambda v, d: vocab_mod.assign_words(v, d))
        w_d = np.asarray(assign(voc, jnp.asarray(fc.desc)))
        w_c = np.asarray(assign(jax.device_put(voc, cpu), to_cpu(fc.desc)))
        assert (w_d == w_c).all(), "vocabulary word assignments"
        out["vocab_words_checked"] = int(len(w_d))

    # Stereo on identical features: same matches, same sub-pixel columns.
    fr = jax.tree.map(np.asarray, ext(to_cpu(r)))
    sc = jnp.asarray(scales)
    match = jax.jit(lambda a, b: stereo.match_stereo_features(
        a, b, sc, float(cam.bf)))
    u_d, _, ok_d = map(np.asarray, match(jax.tree.map(jnp.asarray, fc),
                                         jax.tree.map(jnp.asarray, fr)))
    u_c, _, ok_c = map(np.asarray, match(jax.tree.map(to_cpu, fc),
                                         jax.tree.map(to_cpu, fr)))
    both = ok_d & ok_c
    out["stereo_matches"] = int(ok_c.sum())
    out["stereo_ok_disagree"] = int((ok_d != ok_c).sum())
    out["stereo_max_du"] = float(np.abs(u_d - u_c)[both].max(initial=0.0))
    # The SAD sums reduce in another order on each backend, so a near-tied
    # slide position or the median cut may flip for a few matches.
    assert out["stereo_ok_disagree"] <= max(2, ok_c.sum() // 100), out
    assert (np.abs(u_d - u_c)[both] < 1e-2).mean() >= 0.99, out
    log(f"[frontend] {out}")
    return out


# ---------------------------------------------------------------------------
# Global bundle adjustment at the bench's size
# ---------------------------------------------------------------------------

GBA_SIZE = dict(n_kf=1536, n_pts=196608, obs_per_kf=512)


def gba_map(cam, cfg: SlamConfig, n_kf: int, n_pts: int, obs_per_kf: int,
            point_noise: float = 0.0):
    """Synthetic whole-map GBA problem: keyframes along a 60 m straight
    path, each observing a sliding window of `obs_per_kf` landmarks in a
    band ahead of it with 0.5 px pixel noise. `point_noise` (m) perturbs
    the initial landmark positions. Returns (MapState, SlamConfig)."""
    from .mapstate import mapstate as ms

    cap = CapacityConfig(
        max_keyframes=max(2048, n_kf), max_map_points=max(262144, n_pts),
        max_features=cfg.capacity.max_features,
        local_window_kfs=cfg.capacity.local_window_kfs,
        local_window_mps=cfg.capacity.local_window_mps,
    )
    cfg = cfg.replace(capacity=cap)
    rng = np.random.default_rng(0)
    m = ms.empty(cap)

    t = np.linspace(0, 60.0, n_kf)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (cap.max_keyframes, 1, 1))
    Tcw[:n_kf, 2, 3] = -t  # camera advancing along +z
    X = np.zeros((cap.max_map_points, 3), np.float32)
    X[:n_pts, 0] = rng.uniform(-8, 8, n_pts)
    X[:n_pts, 1] = rng.uniform(-2, 2, n_pts)
    X[:n_pts, 2] = rng.uniform(2, 80, n_pts) + np.repeat(
        np.linspace(0, 60.0, n_pts // 64 + 1), 64)[:n_pts]

    F = cap.max_features
    mp_idx = np.full((cap.max_keyframes, F), -1, np.int32)
    fv = np.zeros((cap.max_keyframes, F), bool)
    xy = np.zeros((cap.max_keyframes, F, 2), np.float32)
    ur = np.full((cap.max_keyframes, F), -1.0, np.float32)
    stride = max(1, (n_pts - obs_per_kf) // max(n_kf - 1, 1))
    for k in range(n_kf):
        pts = (k * stride + np.arange(obs_per_kf)) % n_pts
        Xc = X[pts] - np.array([0, 0, -t[k]], np.float32)  # world->cam
        z = np.maximum(Xc[:, 2], 0.5)
        u = cam.fx * Xc[:, 0] / z + cam.cx + rng.normal(0, 0.5, obs_per_kf)
        v = cam.fy * Xc[:, 1] / z + cam.cy + rng.normal(0, 0.5, obs_per_kf)
        mp_idx[k, :obs_per_kf] = pts
        fv[k, :obs_per_kf] = True
        xy[k, :obs_per_kf, 0] = u
        xy[k, :obs_per_kf, 1] = v
        ur[k, :obs_per_kf] = u - cam.bf / z
    if point_noise:
        X[:n_pts] += rng.normal(0, point_noise, (n_pts, 3)).astype(np.float32)

    kf = m.kf._replace(
        Tcw=jnp.asarray(Tcw),
        valid=jnp.asarray(np.arange(cap.max_keyframes) < n_kf),
        xy=jnp.asarray(xy), uright=jnp.asarray(ur),
        fvalid=jnp.asarray(fv), mp_idx=jnp.asarray(mp_idx),
    )
    mp = m.mp._replace(
        pos=jnp.asarray(X),
        valid=jnp.asarray(np.arange(cap.max_map_points) < n_pts),
    )
    m = m._replace(kf=kf, mp=mp, n_kf=jnp.int32(n_kf), n_mp=jnp.int32(n_pts))
    return m, cfg


def gba_check(cam, cfg: SlamConfig, n_kf: int, n_pts: int, obs_per_kf: int,
              log: Log = print) -> dict:
    """Phase 5 of chip_smoke: GBA through `ba_dense.optimize` and through
    `loop.gba.GlobalBARunner`; finite results and a falling cost."""
    from .loop import gba as gba_mod
    from .optim import ba_dense

    m, cfg = gba_map(cam, cfg, n_kf, n_pts, obs_per_kf, point_noise=0.02)
    prob = gba_mod.build_global_problem_dense(
        m, cfg, n_kf_hint=n_kf, n_mp_hint=n_pts)
    iters, cg = cfg.loop.global_ba_iters, cfg.loop.gba_cg_iters
    out = {}
    t0 = time.perf_counter()
    lowered = ba_dense.optimize.lower(cam, prob, n_iters=iters, cg_iters=cg,
                                      huber_iters=3)
    compiled = lowered.compile()
    out["gba_compile_s"] = time.perf_counter() - t0
    log(f"[gba] memory_analysis: {compiled.memory_analysis()}")
    cost0 = float(ba_dense.optimize(cam, prob, n_iters=0, cg_iters=cg,
                                    huber_iters=0).cost)
    res = jax.block_until_ready(compiled(cam, prob))
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(cam, prob))
    out["gba_wall_s"] = time.perf_counter() - t0
    out["gba_lm_iters_per_s"] = iters / out["gba_wall_s"]
    out["gba_cost_initial"] = cost0
    out["gba_cost_final"] = float(res.cost)
    assert np.isfinite(np.asarray(res.Tcw)).all(), "nonfinite GBA poses"
    assert np.isfinite(np.asarray(res.X)).all(), "nonfinite GBA points"
    assert out["gba_cost_final"] < cost0, out

    runner = gba_mod.GlobalBARunner(cam, cfg, synchronous=True)
    t0 = time.perf_counter()
    runner.launch(m)
    m2 = runner.try_merge(m)
    jax.block_until_ready(m2.kf.Tcw)
    out["gba_runner_wall_s"] = time.perf_counter() - t0
    Tcw = np.asarray(m2.kf.Tcw)[:n_kf]
    X = np.asarray(m2.mp.pos)[:n_pts]
    assert runner.runs_finished == 1
    assert np.isfinite(Tcw).all() and np.isfinite(X).all()
    moved = float(np.abs(X - np.asarray(m.mp.pos)[:n_pts]).max())
    assert moved > 0, "GBA runner left the map unchanged"
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"[gba] {out}")
    return out


# ---------------------------------------------------------------------------
# Closed-orbit loop closure
# ---------------------------------------------------------------------------

def closed_orbit(step: float = 0.10, radius: float = 5.0, extra: int = 8,
                 frames: int = 0,
                 log: Log = print) -> dict:
    """One lap of the orbit plus `extra` revisit frames through
    CorbslamClient with loop closing and GBA; returns loop stats and the
    aligned ATE of the frames and of the corrected keyframes."""
    from . import system as system_mod
    from .frontend import frame as frame_mod
    from .place import vocab as vocab_mod

    cam, cfg = ORBIT_CAM, ORBIT_CFG
    n = frames or int(np.ceil(2 * np.pi / step)) + extra
    world = synthetic.MultiPlaneWorld.room(
        cam, half=14.0, height=3.0, noise_std=3.0, seed=2)

    def orbit_pose(i):
        Twc = se3.compose(
            se3.exp(jnp.asarray([0, 0, 0, 0.0, step * i, 0.0], jnp.float32)),
            se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -radius])),
        )
        return se3.inverse(Twc)

    gt = [orbit_pose(i) for i in range(n)]
    # Vocabulary from a few renders (stands in for the pre-trained ORBvoc).
    descs = []
    for i in (0, n // 3, 2 * n // 3):
        img, _ = world.render_stereo(gt[i], frame=i)
        f = frame_mod.build_frame_mono(img, cam, cfg.orb)
        descs.append(np.asarray(f.desc)[np.asarray(f.fvalid)])
    voc = vocab_mod.train(jnp.asarray(np.concatenate(descs)),
                          n_words=1024, n_iters=6)

    c = system_mod.CorbslamClient(
        cam, cfg, sensor="stereo", client_id=1, voc=voc,
        enable_loop_closing=True, run_gba=True,
    )
    c.loop_closer.gba_runner.synchronous = True
    t0 = time.perf_counter()
    loop_at = None
    for i in range(n):
        l, r = world.render_stereo(gt[i], frame=i)
        c.track_stereo(l, r, timestamp=i * 0.1)
        if loop_at is None and c.loop_closer.stats.n_loops_closed > 0:
            loop_at = i
    c.shutdown()
    dt = time.perf_counter() - t0

    gtw = np.asarray([np.linalg.inv(np.asarray(T)) for T in gt])
    est = np.asarray([np.linalg.inv(np.asarray(T))
                      for _, T in c.tracker.trajectory])
    m = c.tracker.map
    kf_valid = np.asarray(m.kf.valid)
    kf_fid = np.asarray(m.kf.frame_id)[kf_valid]
    kf_Tcw = np.asarray(m.kf.Tcw)[kf_valid]
    finite = np.isfinite(kf_Tcw).all(axis=(1, 2))
    sel = (kf_fid < len(gtw)) & finite
    est_kf = np.asarray([np.linalg.inv(T) for T in kf_Tcw[sel]])
    ate_kf = (trajectory.ate_rmse(est_kf, gtw[kf_fid[sel]], align=True)
              if sel.sum() >= 3 else float("nan"))
    lc = c.loop_closer
    out = {
        "frames": n,
        "wall_s": dt,
        "n_keyframes": int(c.tracker.stats.n_keyframes),
        "loop_detections": lc.stats.n_detections,
        "sim3_attempts": lc.stats.n_sim3_attempts,
        "loops_closed": lc.stats.n_loops_closed,
        "loop_at_frame": loop_at,
        "ate_rmse_frames": float(trajectory.ate_rmse(est, gtw, align=True)),
        "ate_rmse_keyframes_post": float(ate_kf),
        "nonfinite_kf_poses": int((~finite).sum()),
        "sim3_log_tail": lc.stats.sim3_log[-8:],
    }
    log(f"[loop] {out}")
    return out
