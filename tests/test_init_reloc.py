"""Tests: closed-form small-matrix spectral ops, monocular two-view
initialization (F and H paths), inter-keyframe triangulation, and
relocalization — SURVEY.md §7.2 step 9 capabilities on synthetic scenes
with known ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.config import CapacityConfig, OrbConfig, SlamConfig
from corbslam.frontend import frame as frame_mod
from corbslam.frontend import reloc
from corbslam.geometry import camera, linalg3, se3
from corbslam.mapping import triangulation
from corbslam.mapstate import mapstate as ms
from corbslam.place import database as db_mod
from corbslam.place import vocab as vocab_mod
from corbslam.solvers import initializer

CAM = camera.Intrinsics.create(
    fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240
)

CFG = SlamConfig(
    orb=OrbConfig(n_features=128, n_levels=4),
    capacity=CapacityConfig(
        max_keyframes=32, max_map_points=2048, max_features=128,
        local_window_kfs=8, local_window_mps=512,
    ),
)
F = CFG.capacity.max_features


class TestLinalg3:
    def test_eigh3x3_matches_numpy(self, rng):
        A = rng.normal(size=(64, 3, 3)).astype(np.float32)
        A = A + np.swapaxes(A, -1, -2)
        w, V = linalg3.eigh3x3(jnp.asarray(A))
        w_np = np.linalg.eigvalsh(A)
        assert np.allclose(np.asarray(w), w_np, atol=1e-3)
        # Eigenvector property: ||A v - w v|| small.
        Av = np.einsum("bij,bjk->bik", A, np.asarray(V))
        wV = np.asarray(w)[:, None, :] * np.asarray(V)
        assert np.abs(Av - wV).max() < 5e-3

    def test_svd3x3(self, rng):
        M = rng.normal(size=(32, 3, 3)).astype(np.float32)
        U, s, V = linalg3.svd3x3(jnp.asarray(M))
        rec = np.einsum(
            "bij,bj,bkj->bik", np.asarray(U), np.asarray(s), np.asarray(V)
        )
        assert np.abs(rec - M).max() < 5e-3
        s_np = np.linalg.svd(M, compute_uv=False)
        assert np.allclose(np.asarray(s), s_np, atol=1e-3)

    def test_smallest_eigvec(self, rng):
        A = rng.normal(size=(16, 9, 9)).astype(np.float32)
        A = A @ np.swapaxes(A, -1, -2)
        v = np.asarray(linalg3.smallest_eigvec_sym(jnp.asarray(A)))
        w_np, V_np = np.linalg.eigh(A)
        cos = np.abs(np.einsum("bi,bi->b", v, V_np[:, :, 0]))
        assert (cos > 0.99).all()


def two_view_scene(rng, n=200, planar=False, tx=0.4, yaw=0.05, noise=0.3):
    """Matched pixel pairs from two views of a synthetic scene."""
    if planar:
        X = np.stack([
            rng.uniform(-5, 5, n), rng.uniform(-4, 4, n), np.full(n, 10.0)
        ], -1).astype(np.float32)
    else:
        X = np.stack([
            rng.uniform(-5, 5, n), rng.uniform(-4, 4, n), rng.uniform(6, 16, n)
        ], -1).astype(np.float32)
    T21 = np.asarray(
        se3.exp(jnp.asarray([-tx, 0.02, 0.01, 0.0, yaw, 0.0], jnp.float32))
    )

    def proj(T, X):
        p = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([
            CAM.fx * p[:, 0] / p[:, 2] + CAM.cx,
            CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
        ], -1).astype(np.float32)

    xy1 = proj(np.eye(4), X) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    xy2 = proj(T21, X) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    inb = (
        (xy1 > 5).all(-1) & (xy1 < [315, 235]).all(-1)
        & (xy2 > 5).all(-1) & (xy2 < [315, 235]).all(-1)
    )
    return xy1, xy2, inb, T21, X


class TestInitializer:
    def check(self, res, T21):
        assert bool(res.ok), (int(res.n_good), float(res.score_h), float(res.score_f))
        R_est = np.asarray(res.R)
        t_est = np.asarray(res.t)
        R_gt = T21[:3, :3]
        t_gt = T21[:3, 3] / np.linalg.norm(T21[:3, 3])
        assert np.abs(R_est - R_gt).max() < 0.02, R_est - R_gt
        assert np.abs(np.abs(t_est @ t_gt) - 1.0) < 0.01  # direction (scale-free)

    def test_general_scene_uses_F(self, rng):
        xy1, xy2, ok, T21, X = two_view_scene(rng, planar=False)
        res = initializer.initialize_two_view(
            CAM, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(ok),
            jax.random.PRNGKey(0),
        )
        assert not bool(res.used_H)
        self.check(res, T21)
        # Triangulated structure matches GT up to the mono scale factor.
        good = np.asarray(res.good)
        scale = np.median(np.asarray(res.X)[good][:, 2] / X[good][:, 2])
        rel = np.abs(np.asarray(res.X)[good] - scale * X[good]) / 10.0
        # Depth noise floor: z^2/(f*b) * sigma_px*sqrt(2) ~ 3% at this
        # geometry (0.3 px noise, 10 m scene, ~0.4 m baseline).
        assert np.median(rel) < 0.05

    def test_planar_scene_uses_H(self, rng):
        xy1, xy2, ok, T21, X = two_view_scene(rng, planar=True)
        res = initializer.initialize_two_view(
            CAM, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(ok),
            jax.random.PRNGKey(0),
        )
        assert bool(res.used_H)
        self.check(res, T21)

    def test_insufficient_parallax_rejected(self, rng):
        xy1, xy2, ok, T21, X = two_view_scene(rng, tx=0.0005, yaw=0.0)
        res = initializer.initialize_two_view(
            CAM, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(ok),
            jax.random.PRNGKey(0),
        )
        assert not bool(res.ok)


def map_with_unbound_pair(rng, n=80):
    """Two keyframes + a third; KFs 0/1 share bound landmarks (covisibility)
    while a fresh batch of features is UNBOUND in both — triangulation fodder."""
    m = ms.empty(CFG.capacity)
    X_bound = np.stack([
        rng.uniform(-3, 3, 40), rng.uniform(-2, 2, 40), rng.uniform(7, 12, 40)
    ], -1).astype(np.float32)
    X_new = np.stack([
        rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(7, 12, n)
    ], -1).astype(np.float32)
    desc_b = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    desc_n = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    T0 = np.eye(4, dtype=np.float32)
    T1 = np.asarray(se3.exp(jnp.asarray([-0.6, 0, 0, 0, 0.03, 0], jnp.float32)))

    def proj(T, X):
        p = X @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([
            CAM.fx * p[:, 0] / p[:, 2] + CAM.cx,
            CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
        ], -1).astype(np.float32)
        return uv, p[:, 2]

    # Bound landmarks.
    p_cam = X_bound
    dist = np.linalg.norm(p_cam, axis=-1).astype(np.float32)
    m, rows = ms.add_map_points(
        m, jnp.asarray(X_bound), jnp.asarray(desc_b),
        normal=jnp.asarray(X_bound / dist[:, None]),
        min_dist=jnp.asarray(dist / 1.2 ** 3), max_dist=jnp.asarray(dist),
        ref_kf=0, create=jnp.ones(40, bool),
    )
    rows = np.asarray(rows)

    def insert(m, T, fid):
        uv_b, _ = proj(T, X_bound)
        uv_n, _ = proj(T, X_new)
        k = 40 + n
        xy = np.zeros((F, 2), np.float32)
        xy[:40] = uv_b; xy[40:k] = uv_n
        desc = np.zeros((F, 32), np.uint8)
        desc[:40] = desc_b; desc[40:k] = desc_n
        fv = np.zeros(F, bool); fv[:k] = True
        mp_idx = np.full(F, ms.NO_MP, np.int32)
        mp_idx[:40] = rows
        m, row = ms.insert_keyframe(
            m, jnp.asarray(np.asarray(T, np.float32)), jnp.asarray(xy),
            jnp.zeros(F, jnp.int32), jnp.zeros(F, jnp.float32),
            jnp.asarray(desc), jnp.full(F, -1.0, jnp.float32),
            jnp.zeros(F, jnp.float32), jnp.asarray(fv), jnp.asarray(mp_idx),
            frame_id=fid, timestamp=float(fid),
        )
        return m, int(row)

    m, r0 = insert(m, T0, 0)
    m, r1 = insert(m, T1, 1)
    return m, r1, X_new


class TestTriangulation:
    def test_creates_points_matching_gt(self, rng):
        m, kf_new, X_new = map_with_unbound_pair(rng)
        n0 = int(m.n_mp)
        m2 = triangulation.create_new_points(CAM, m, kf_new, CFG)
        n1 = int(m2.n_mp)
        created = n1 - n0
        assert created > 40, created
        pos = np.asarray(m2.mp.pos[n0:n1])
        d = np.linalg.norm(pos[:, None, :] - X_new[None], axis=-1).min(axis=1)
        assert np.median(d) < 0.05, np.median(d)
        # Both keyframes observe the new points.
        idx0 = np.asarray(m2.kf.mp_idx[0])
        idx1 = np.asarray(m2.kf.mp_idx[kf_new])
        assert (idx1 >= n0).sum() > 40
        assert (idx0 >= n0).sum() > 40

    def test_no_points_without_baseline(self, rng):
        m, kf_new, _ = map_with_unbound_pair(rng)
        # Collapse the second pose onto the first: zero baseline.
        m = m._replace(kf=m.kf._replace(Tcw=m.kf.Tcw.at[1].set(jnp.eye(4))))
        n0 = int(m.n_mp)
        m2 = triangulation.create_new_points(CAM, m, kf_new, CFG)
        assert int(m2.n_mp) == n0


class TestRelocalization:
    def test_recovers_pose(self, rng):
        from test_loop import build_loop_map, CFG as LCFG

        m, gt, est, kf_c, kf_q = build_loop_map(rng)
        voc = vocab_mod.train(
            jnp.asarray(rng.integers(0, 256, (1000, 32), dtype=np.uint8)),
            n_words=128, n_iters=3,
        )
        db = db_mod.BowDatabase.empty(LCFG.capacity.max_keyframes, voc.n_words)
        for r in range(int(m.n_kf)):
            db = db.add(r, vocab_mod.transform(voc, m.kf.desc[r], m.kf.fvalid[r]))

        # A LOST frame: keyframe 5's features, true pose unknown to the tracker.
        Fq = LCFG.capacity.max_features
        frame = frame_mod.FrameData(
            Tcw=jnp.eye(4),
            xy=m.kf.xy[5], octave=m.kf.octave[5], angle=m.kf.angle[5],
            desc=m.kf.desc[5], uright=m.kf.uright[5], depth=m.kf.depth[5],
            fvalid=m.kf.fvalid[5],
            mp_idx=jnp.full(Fq, ms.NO_MP, jnp.int32),
        )
        res = reloc.relocalize(
            CAM, m, db, voc, frame, jax.random.PRNGKey(0), LCFG
        )
        assert res is not None
        assert np.allclose(np.asarray(res.Tcw), np.asarray(m.kf.Tcw[5]), atol=1e-2)
        assert int(res.n_inliers) >= 30
