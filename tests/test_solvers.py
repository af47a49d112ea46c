"""Tests for the geometric solvers (Horn Sim3 RANSAC, PnP RANSAC)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.geometry import camera, se3, sim3
from corbslam.solvers import pnp, sim3_solver

CAM = camera.Intrinsics.create(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
)


class TestHorn:
    def test_exact_recovery(self, rng):
        p2 = rng.normal(size=(10, 3)).astype(np.float32) * 5
        xi = np.array([0.5, -0.3, 0.8, 0.2, -0.1, 0.3, 0.4], np.float32)
        S = sim3.exp(jnp.asarray(xi))
        p1 = np.asarray(sim3.transform(S, jnp.asarray(p2)))
        R, t, s = sim3_solver.horn_sim3(jnp.asarray(p1), jnp.asarray(p2))
        Rt, tt, st = (np.asarray(x) for x in S)
        np.testing.assert_allclose(np.asarray(R), Rt, atol=1e-3)
        np.testing.assert_allclose(np.asarray(t), tt, atol=1e-2)
        np.testing.assert_allclose(np.asarray(s), st, atol=1e-3)

    def test_batched(self, rng):
        # 8-point sets: well-conditioned. (Minimal 3-point sets can be near
        # collinear; RANSAC's inlier vote handles those — covered below.)
        p2 = rng.normal(size=(16, 8, 3)).astype(np.float32) * 5
        xi = (rng.normal(size=(16, 7)) * 0.4).astype(np.float32)
        S = sim3.exp(jnp.asarray(xi))
        p1 = np.asarray(sim3.transform((S[0][:, None], S[1][:, None], S[2][:, None]), jnp.asarray(p2)))
        R, t, s = sim3_solver.horn_sim3(jnp.asarray(p1), jnp.asarray(p2))
        np.testing.assert_allclose(np.asarray(R), np.asarray(S[0]), atol=5e-3)

    def test_fixed_scale(self, rng):
        p2 = rng.normal(size=(10, 3)).astype(np.float32) * 5
        T = se3.exp(jnp.asarray([0.3, 0.1, -0.2, 0.1, 0.2, -0.1]))
        p1 = np.asarray(se3.transform(T, jnp.asarray(p2)))
        R, t, s = sim3_solver.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix_scale=True)
        assert float(s) == 1.0
        np.testing.assert_allclose(np.asarray(R), np.asarray(se3.rotation(T)), atol=1e-3)


class TestSim3Ransac:
    def test_recovers_with_outliers(self, rng):
        N = 100
        # Points in camera-2 frame, in front of both cameras.
        p2 = np.stack(
            [rng.uniform(-8, 8, N), rng.uniform(-3, 3, N), rng.uniform(8, 30, N)], -1
        ).astype(np.float32)
        xi = np.array([0.4, -0.2, 0.5, 0.05, -0.1, 0.08, 0.15], np.float32)
        S = sim3.exp(jnp.asarray(xi))
        p1 = np.array(sim3.transform(S, jnp.asarray(p2)))
        out = rng.choice(N, 30, replace=False)
        p1[out] += rng.uniform(2, 5, (30, 3)) * rng.choice([-1, 1], (30, 3))
        res = sim3_solver.solve_sim3_ransac(
            CAM, CAM, jnp.asarray(p1), jnp.asarray(p2), jnp.ones(N, bool),
            jnp.ones(N, jnp.float32), jnp.ones(N, jnp.float32),
            jax.random.PRNGKey(0), n_hyp=256,
        )
        assert bool(res.ok)
        assert int(res.n_inliers) >= 60
        Rt, tt, st = (np.asarray(x) for x in S)
        np.testing.assert_allclose(np.asarray(res.R), Rt, atol=0.02)
        np.testing.assert_allclose(float(res.s), float(st), rtol=0.02)
        inl = np.asarray(res.inliers)
        assert inl[out].mean() < 0.2  # outliers excluded

    def test_iterative_refinement_beats_single_refit(self, rng):
        """Borderline seam (VERDICT r3 #9): heavy noise + outliers leave the
        RANSAC model coarse, so its consensus gate misses borderline-true
        matches. Iterative re-classification + Huber refit must (a) recover
        more inliers and (b) align tighter than one weighted consensus
        refit — the reference's OptimizeSim3 behavior (Optimizer.cc:1120)."""
        N = 120
        p2 = np.stack(
            [rng.uniform(-8, 8, N), rng.uniform(-3, 3, N),
             rng.uniform(8, 30, N)], -1
        ).astype(np.float32)
        xi = np.array([0.4, -0.2, 0.5, 0.05, -0.1, 0.08, 0.12], np.float32)
        S = sim3.exp(jnp.asarray(xi))
        p1 = np.array(sim3.transform(S, jnp.asarray(p2)))
        # Strong anisotropic noise: many matches sit near the chi2 gate.
        p1 += rng.normal(size=(N, 3)).astype(np.float32) * [0.05, 0.05, 0.6]
        out = rng.choice(N, 36, replace=False)
        p1[out] += (rng.uniform(2, 5, (36, 3))
                    * rng.choice([-1, 1], (36, 3))).astype(np.float32)
        ones = jnp.ones(N, jnp.float32)
        # Few hypotheses -> coarse RANSAC model (borderline seam).
        res = sim3_solver.solve_sim3_ransac(
            CAM, CAM, jnp.asarray(p1), jnp.asarray(p2), jnp.ones(N, bool),
            ones, ones, jax.random.PRNGKey(3), n_hyp=16,
        )
        # Single weighted consensus refit (the r3 path), re-classified once.
        w = res.inliers.astype(jnp.float32)
        R1, t1, s1 = sim3_solver.horn_sim3(
            jnp.asarray(p1), jnp.asarray(p2), False, w=w)
        e1, e2, pos = sim3_solver._sim3_chi2(
            CAM, CAM, jnp.asarray(p1), jnp.asarray(p2), R1, t1, s1)
        n_single = int(np.asarray((e1 < 9.21) & (e2 < 9.21) & pos).sum())
        # Iterative reprojection GN with re-classification.
        Rn, tn, sn, inl_n, n_n = sim3_solver.refine_sim3_iterative(
            CAM, CAM, jnp.asarray(p1), jnp.asarray(p2), jnp.ones(N, bool),
            ones, ones, res.R, res.t, res.s, n_rounds=4,
        )
        Rt = np.asarray(S[0])
        err1 = np.abs(np.asarray(R1) - Rt).max()
        errn = np.abs(np.asarray(Rn) - Rt).max()
        # More inliers than both the RANSAC consensus and the single refit...
        assert int(n_n) > int(res.n_inliers), (int(n_n), int(res.n_inliers))
        assert int(n_n) > n_single, (int(n_n), n_single)
        # ...and a tighter model.
        assert errn < err1, (errn, err1)
        assert errn < 0.01
        assert bool(np.asarray(inl_n)[out].mean() < 0.2)


class TestPnP:
    def test_recovers_pose_with_outliers(self, rng):
        N = 200
        X = np.stack(
            [rng.uniform(-15, 15, N), rng.uniform(-5, 5, N), rng.uniform(8, 40, N)], -1
        ).astype(np.float32)
        T_true = se3.exp(jnp.asarray([0.4, -0.2, 0.3, 0.05, -0.08, 0.1]))
        uv = np.array(camera.project(CAM, se3.transform(T_true, jnp.asarray(X))))
        uv += rng.normal(scale=0.5, size=uv.shape)
        out = rng.choice(N, 60, replace=False)
        uv[out] += rng.uniform(30, 100, (60, 2)) * rng.choice([-1, 1], (60, 2))
        res = pnp.solve_pnp_ransac(
            CAM, jnp.asarray(X), jnp.asarray(uv.astype(np.float32)),
            jnp.ones(N, bool), jnp.ones(N, jnp.float32),
            jax.random.PRNGKey(1), n_hyp=256,
        )
        assert bool(res.ok)
        assert int(res.n_inliers) >= 120
        err = np.asarray(se3.log(se3.compose(res.Tcw, se3.inverse(T_true))))
        assert np.abs(err[:3]).max() < 0.05
        assert np.abs(err[3:]).max() < 0.01

    def test_fails_gracefully_on_garbage(self, rng):
        N = 50
        X = rng.normal(size=(N, 3)).astype(np.float32) * 10
        uv = rng.uniform(0, 1000, (N, 2)).astype(np.float32)
        res = pnp.solve_pnp_ransac(
            CAM, jnp.asarray(X), jnp.asarray(uv), jnp.ones(N, bool),
            jnp.ones(N, jnp.float32), jax.random.PRNGKey(2), n_hyp=64,
        )
        assert not bool(res.ok)
        assert bool(jnp.isfinite(res.Tcw).all())
