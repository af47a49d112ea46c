"""Dense-plane BA engine (optim/ba_dense) vs the flat engine and ground
truth: same math, tile-native layout (see ba_dense module docstring)."""

import jax.numpy as jnp
import numpy as np

from corbslam.geometry import camera, se3
from corbslam.optim import ba, ba_dense

from test_optim import CAM, make_ba_scene, mean_reproj_err


def flat_to_dense(prob: ba.BAProblem, Fb: int) -> ba_dense.BADense:
    """Test helper: bucket a flat observation list by camera row."""
    C = prob.Tcw.shape[0]
    oc = np.asarray(prob.obs_cam)
    op = np.asarray(prob.obs_point)
    uvr = np.asarray(prob.obs_uvr)
    isig = np.asarray(prob.obs_inv_sigma2)
    st = np.asarray(prob.obs_stereo)
    ov = np.asarray(prob.obs_valid)

    ids = np.zeros((C, Fb), np.int32)
    u = np.zeros((3, C, Fb), np.float32)
    w = np.zeros((C, Fb), np.float32)
    stereo = np.zeros((C, Fb), bool)
    act = np.zeros((C, Fb), bool)
    fill = np.zeros(C, np.int32)
    for o in range(len(oc)):
        if not ov[o]:
            continue
        c, k = oc[o], fill[oc[o]]
        assert k < Fb, "raise Fb for this scene"
        ids[c, k] = op[o]
        u[:, c, k] = uvr[o]
        w[c, k] = isig[o]
        stereo[c, k] = st[o]
        act[c, k] = True
        fill[c] += 1
    return ba_dense.BADense(
        Tcw=prob.Tcw, pose_fixed=prob.pose_fixed,
        X=prob.X, point_fixed=prob.point_fixed,
        obs_mp=jnp.asarray(ids), obs_uvr=jnp.asarray(u),
        obs_inv_sigma2=jnp.asarray(w), obs_stereo=jnp.asarray(stereo),
        obs_active=jnp.asarray(act),
    )


class TestBADense:
    def test_converges_from_perturbation(self, rng):
        Tcw_true, X_true, prob = make_ba_scene(rng)
        dT = rng.normal(scale=0.03, size=(6, 6)).astype(np.float32)
        dT[0] = 0
        Tp = np.asarray(se3.retract(prob.Tcw, jnp.asarray(dT)))
        Xp = X_true + rng.normal(scale=0.3, size=X_true.shape).astype(np.float32)
        dense = flat_to_dense(
            prob._replace(Tcw=jnp.asarray(Tp), X=jnp.asarray(Xp)), Fb=384)

        err_before = mean_reproj_err(CAM, prob, Tp, Xp)
        res = ba_dense.optimize(CAM, dense, n_iters=12, cg_iters=30)
        err_after = mean_reproj_err(
            CAM, prob, np.asarray(res.Tcw), np.asarray(res.X))
        assert err_before > 5.0
        assert err_after < 0.5
        for c in range(1, 6):
            e = np.asarray(se3.log(se3.compose(
                res.Tcw[c], se3.inverse(jnp.asarray(Tcw_true[c])))))
            assert np.abs(e).max() < 0.02, (c, e)
        inl = np.asarray(res.inlier)
        act = np.asarray(dense.obs_active)
        assert inl[act].mean() > 0.95

    def test_matches_flat_engine(self, rng):
        """Both engines implement the same LM schedule; from the same start
        they must land on equivalent optima (pose agreement ~1e-3)."""
        _, X_true, prob = make_ba_scene(rng, n_cams=5, n_points=200)
        dT = rng.normal(scale=0.02, size=(5, 6)).astype(np.float32)
        dT[0] = 0
        Tp = se3.retract(prob.Tcw, jnp.asarray(dT))
        Xp = jnp.asarray(
            X_true + rng.normal(scale=0.2, size=X_true.shape).astype(np.float32))
        prob_p = prob._replace(Tcw=Tp, X=Xp)
        dense = flat_to_dense(prob_p, Fb=256)

        res_f = ba.optimize(CAM, prob_p, n_iters=10, cg_iters=30)
        res_d = ba_dense.optimize(CAM, dense, n_iters=10, cg_iters=30)
        for c in range(5):
            e = np.asarray(se3.log(se3.compose(
                res_d.Tcw[c], se3.inverse(res_f.Tcw[c]))))
            assert np.abs(e).max() < 2e-3, (c, e)

    def test_fixed_poses_stay_fixed(self, rng):
        _, _, prob = make_ba_scene(rng, n_cams=4, n_points=100)
        fixed = jnp.asarray([True, True, False, False])
        dT = rng.normal(scale=0.02, size=(4, 6)).astype(np.float32)
        dT[:2] = 0
        prob = prob._replace(
            pose_fixed=fixed, Tcw=se3.retract(prob.Tcw, jnp.asarray(dT)))
        dense = flat_to_dense(prob, Fb=128)
        T_before = np.asarray(dense.Tcw)
        res = ba_dense.optimize(CAM, dense, n_iters=8, cg_iters=25)
        np.testing.assert_array_equal(np.asarray(res.Tcw)[:2], T_before[:2])

    def test_outliers_rejected(self, rng):
        _, _, prob = make_ba_scene(rng, n_cams=4, n_points=150, noise=0.1)
        uvr = np.asarray(prob.obs_uvr).copy()
        O = uvr.shape[0]
        out_idx = rng.choice(O, O // 10, replace=False)
        uvr[out_idx, :2] += 50.0
        prob = prob._replace(obs_uvr=jnp.asarray(uvr))
        dense = flat_to_dense(prob, Fb=192)
        res = ba_dense.optimize(CAM, dense, n_iters=12, cg_iters=25)
        # Map outlier flat indices to dense slots to check classification.
        inl = np.asarray(res.inlier)
        act = np.asarray(dense.obs_active)
        oc = np.asarray(prob.obs_cam)
        fill = np.zeros(4, np.int32)
        slot = np.zeros(O, np.int32)
        for o in range(O):
            slot[o] = fill[oc[o]]
            fill[oc[o]] += 1
        out_mask = np.zeros(O, bool)
        out_mask[out_idx] = True
        inl_flat = inl[oc, slot]
        assert inl_flat[out_mask].mean() < 0.05
        assert inl_flat[~out_mask].mean() > 0.9
        assert act[oc, slot].all()

    def test_problem_from_map_counts(self, rng):
        """problem_from_map compacts valid observations per keyframe and
        drops none when the budget covers them."""
        from corbslam.config import SlamConfig, CapacityConfig
        from corbslam.mapstate import mapstate as ms

        cfg = SlamConfig(capacity=CapacityConfig(
            max_keyframes=8, max_map_points=64, max_features=16))
        m = ms.empty(cfg.capacity)
        kf = m.kf._replace(
            valid=jnp.asarray(np.arange(8) < 4),
            mp_idx=m.kf.mp_idx.at[:4, :10].set(
                jnp.asarray(rng.integers(0, 32, (4, 10)), jnp.int32)),
            fvalid=m.kf.fvalid.at[:4, :10].set(True),
            uright=m.kf.uright.at[:4, :10].set(100.0),
        )
        mp = m.mp._replace(valid=jnp.asarray(np.arange(64) < 32))
        m = m._replace(kf=kf, mp=mp, n_kf=jnp.int32(4), n_mp=jnp.int32(32))
        prob = ba_dense.problem_from_map(m, 1.2, obs_per_kf=12)
        act = np.asarray(prob.obs_active)
        assert act.shape == (8, 12)
        assert act[:4].sum() == 40    # all 10 obs of each of 4 KFs kept
        assert act[4:].sum() == 0
        assert bool(prob.pose_fixed[0])
