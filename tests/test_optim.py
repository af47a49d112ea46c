"""Tests for the LM optimization core (pose opt + Schur BA) on synthetic
scenes with exact ground truth — the validation the reference never had for
its g2o drivers (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.geometry import camera, se3
from corbslam.optim import ba, pose_opt, reproj
from corbslam.optim.smallmat import chol_solve_unrolled, inv_spd_unrolled

CAM = camera.Intrinsics.create(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
    width=1241, height=376,
)


def make_scene(rng, n_points=200, noise=0.3, outlier_frac=0.0, stereo=True):
    """Points in front of a ground-truth camera + noisy observations."""
    X = np.stack(
        [rng.uniform(-15, 15, n_points), rng.uniform(-5, 5, n_points),
         rng.uniform(8, 40, n_points)], -1
    ).astype(np.float32)
    xi_true = np.array([0.3, -0.1, 0.2, 0.02, -0.04, 0.01], np.float32)
    T_true = se3.exp(jnp.asarray(xi_true))
    p_cam = se3.transform(T_true, jnp.asarray(X))
    uvr = np.array(camera.project_stereo(CAM, p_cam))
    uvr += rng.normal(scale=noise, size=uvr.shape)
    n_out = int(outlier_frac * n_points)
    if n_out:
        idx = rng.choice(n_points, n_out, replace=False)
        uvr[idx, :2] += rng.uniform(30, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    is_stereo = np.full(n_points, stereo)
    inv_sigma2 = np.ones(n_points, np.float32)
    return X, T_true, uvr.astype(np.float32), is_stereo, inv_sigma2


class TestSmallMat:
    def test_chol_solve(self, rng):
        for n in (3, 6, 7):
            A = rng.normal(size=(50, n, n)).astype(np.float32)
            A = A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
            b = rng.normal(size=(50, n)).astype(np.float32)
            x = np.asarray(chol_solve_unrolled(jnp.asarray(A), jnp.asarray(b), n))
            np.testing.assert_allclose(
                np.einsum("bij,bj->bi", A, x), b, atol=5e-3
            )

    def test_inv_spd(self, rng):
        A = rng.normal(size=(20, 6, 6)).astype(np.float32)
        A = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
        Ainv = np.asarray(inv_spd_unrolled(jnp.asarray(A), 6))
        np.testing.assert_allclose(
            A @ Ainv, np.tile(np.eye(6), (20, 1, 1)), atol=5e-3
        )


class TestReproj:
    def test_jacobians_match_autodiff(self, rng):
        import jax

        X, T_true, uvr, is_stereo, inv_s2 = make_scene(rng, 16, noise=0.0)
        K = 16
        TK = jnp.broadcast_to(T_true, (K, 4, 4))
        res = reproj.linearize(CAM, TK, jnp.asarray(X), jnp.asarray(uvr),
                               jnp.asarray(inv_s2), jnp.asarray(is_stereo))

        def r_of_xi(xi, k):
            T = se3.compose(se3.exp(xi), T_true)
            p = se3.transform(T, jnp.asarray(X[k]))
            pred = camera.project_stereo(CAM, p)
            return jnp.asarray(uvr[k]) - pred

        def r_of_X(Xk, k):
            p = se3.transform(T_true, Xk)
            pred = camera.project_stereo(CAM, p)
            return jnp.asarray(uvr[k]) - pred

        for k in [0, 5, 11]:
            J_pose_ad = np.asarray(jax.jacobian(r_of_xi)(jnp.zeros(6), k))
            J_point_ad = np.asarray(jax.jacobian(r_of_X)(jnp.asarray(X[k]), k))
            np.testing.assert_allclose(np.asarray(res.J_pose)[k], J_pose_ad, atol=1e-3, rtol=1e-3)
            np.testing.assert_allclose(np.asarray(res.J_point)[k], J_point_ad, atol=1e-3, rtol=1e-3)


class TestPoseOpt:
    def test_recovers_pose_clean(self, rng):
        X, T_true, uvr, is_stereo, inv_s2 = make_scene(rng, 200, noise=0.2)
        T0 = se3.retract(T_true, jnp.asarray([0.3, -0.2, 0.25, 0.03, 0.02, -0.04]))
        res = pose_opt.optimize_pose(
            CAM, T0, jnp.asarray(X), jnp.asarray(uvr),
            jnp.asarray(inv_s2), jnp.asarray(is_stereo),
            jnp.ones(200, bool),
        )
        err = np.asarray(se3.log(se3.compose(res.Tcw, se3.inverse(T_true))))
        assert np.abs(err[:3]).max() < 0.01   # translation (m)
        assert np.abs(err[3:]).max() < 0.001  # rotation (rad)
        assert int(res.n_inliers) > 190

    def test_rejects_outliers(self, rng):
        X, T_true, uvr, is_stereo, inv_s2 = make_scene(rng, 300, noise=0.2, outlier_frac=0.3)
        T0 = se3.retract(T_true, jnp.asarray([0.2, 0.1, -0.15, 0.02, -0.01, 0.03]))
        res = pose_opt.optimize_pose(
            CAM, T0, jnp.asarray(X), jnp.asarray(uvr),
            jnp.asarray(inv_s2), jnp.asarray(is_stereo),
            jnp.ones(300, bool),
        )
        err = np.asarray(se3.log(se3.compose(res.Tcw, se3.inverse(T_true))))
        assert np.abs(err[:3]).max() < 0.02
        n_in = int(res.n_inliers)
        assert 180 < n_in <= 215  # ~210 true inliers

    def test_mono_only(self, rng):
        X, T_true, uvr, _, inv_s2 = make_scene(rng, 200, noise=0.2, stereo=False)
        T0 = se3.retract(T_true, jnp.asarray([0.2, -0.1, 0.1, 0.02, 0.01, -0.02]))
        res = pose_opt.optimize_pose(
            CAM, T0, jnp.asarray(X), jnp.asarray(uvr),
            jnp.asarray(inv_s2), jnp.zeros(200, bool),
            jnp.ones(200, bool),
        )
        err = np.asarray(se3.log(se3.compose(res.Tcw, se3.inverse(T_true))))
        assert np.abs(err).max() < 0.02


def make_ba_scene(rng, n_cams=6, n_points=300, noise=0.15):
    """Camera ring looking at a point cloud; every point seen by every cam."""
    X = np.stack(
        [rng.uniform(-10, 10, n_points), rng.uniform(-4, 4, n_points),
         rng.uniform(15, 35, n_points)], -1
    ).astype(np.float32)
    poses = []
    for c in range(n_cams):
        xi = np.array([c * 0.8, 0.05 * c, 0.02 * c, 0.0, 0.03 * c, 0.0], np.float32)
        poses.append(np.asarray(se3.exp(jnp.asarray(xi))))
    Tcw = np.stack(poses)
    obs_cam, obs_point, obs_uvr = [], [], []
    for c in range(n_cams):
        p_cam = np.asarray(se3.transform(jnp.asarray(Tcw[c]), jnp.asarray(X)))
        uvr = np.array(camera.project_stereo(CAM, jnp.asarray(p_cam)))
        uvr += rng.normal(scale=noise, size=uvr.shape)
        ok = (p_cam[:, 2] > 1.0)
        idx = np.where(ok)[0]
        obs_cam.append(np.full(len(idx), c))
        obs_point.append(idx)
        obs_uvr.append(uvr[idx])
    obs_cam = np.concatenate(obs_cam).astype(np.int32)
    obs_point = np.concatenate(obs_point).astype(np.int32)
    obs_uvr = np.concatenate(obs_uvr).astype(np.float32)
    O = len(obs_cam)
    return Tcw, X, ba.BAProblem(
        Tcw=jnp.asarray(Tcw),
        pose_fixed=jnp.asarray(np.arange(n_cams) == 0),
        X=jnp.asarray(X),
        point_fixed=jnp.zeros(n_points, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_point=jnp.asarray(obs_point),
        obs_uvr=jnp.asarray(obs_uvr),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_stereo=jnp.ones(O, bool),
        obs_valid=jnp.ones(O, bool),
    )


def mean_reproj_err(cam, prob, Tcw, X):
    T_o = Tcw[np.asarray(prob.obs_cam)]
    X_o = X[np.asarray(prob.obs_point)]
    p = np.asarray(se3.transform(jnp.asarray(T_o), jnp.asarray(X_o)))
    pred = np.asarray(camera.project_stereo(cam, jnp.asarray(p)))
    return np.linalg.norm(np.asarray(prob.obs_uvr) - pred, axis=-1).mean()


class TestBA:
    def test_converges_from_perturbation(self, rng):
        Tcw_true, X_true, prob = make_ba_scene(rng)
        # Perturb everything except the fixed gauge camera.
        dT = rng.normal(scale=0.03, size=(6, 6)).astype(np.float32)
        dT[0] = 0
        Tp = np.asarray(se3.retract(prob.Tcw, jnp.asarray(dT)))
        Xp = X_true + rng.normal(scale=0.3, size=X_true.shape).astype(np.float32)
        prob_p = prob._replace(Tcw=jnp.asarray(Tp), X=jnp.asarray(Xp))

        err_before = mean_reproj_err(CAM, prob, Tp, Xp)
        res = ba.optimize(CAM, prob_p, n_iters=12, cg_iters=30)
        err_after = mean_reproj_err(CAM, prob, np.asarray(res.Tcw), np.asarray(res.X))
        assert err_before > 5.0
        assert err_after < 0.5
        # Pose recovery (gauge fixed at cam 0 => absolute comparison valid)
        for c in range(1, 6):
            e = np.asarray(se3.log(se3.compose(res.Tcw[c], se3.inverse(jnp.asarray(Tcw_true[c])))))
            assert np.abs(e).max() < 0.02, (c, e)
        assert np.asarray(res.inlier).mean() > 0.95

    def test_fixed_poses_stay_fixed(self, rng):
        _, _, prob = make_ba_scene(rng, n_cams=4, n_points=100)
        fixed = jnp.asarray([True, True, False, False])
        dT = rng.normal(scale=0.02, size=(4, 6)).astype(np.float32)
        dT[:2] = 0
        prob = prob._replace(
            pose_fixed=fixed,
            Tcw=se3.retract(prob.Tcw, jnp.asarray(dT)),
        )
        T_before = np.asarray(prob.Tcw)
        res = ba.optimize(CAM, prob, n_iters=8, cg_iters=25)
        np.testing.assert_array_equal(np.asarray(res.Tcw)[:2], T_before[:2])
        # Free cameras moved back toward truth: reprojection error small
        assert float(res.cost) < 1e4

    def test_outlier_observations_rejected(self, rng):
        _, _, prob = make_ba_scene(rng, n_cams=4, n_points=150, noise=0.1)
        uvr = np.asarray(prob.obs_uvr).copy()
        O = uvr.shape[0]
        out_idx = rng.choice(O, O // 10, replace=False)
        uvr[out_idx, :2] += 50.0
        prob = prob._replace(obs_uvr=jnp.asarray(uvr))
        res = ba.optimize(CAM, prob, n_iters=12, cg_iters=25)
        inl = np.asarray(res.inlier)
        assert inl[out_idx].mean() < 0.05   # outliers detected
        mask = np.ones(O, bool)
        mask[out_idx] = False
        assert inl[mask].mean() > 0.9       # inliers kept
