"""Distributed (sharded) BA vs single-device BA on the 8-device CPU mesh —
the hermetic multi-chip test pattern (SURVEY.md §4 implication)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from corbslam.geometry import camera, se3
from corbslam.optim import ba
from corbslam.parallel import distributed_ba

CAM = camera.Intrinsics.create(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
)


def make_problem(rng, n_cams=8, n_points=500):
    X = np.stack(
        [rng.uniform(-15, 15, n_points), rng.uniform(-5, 5, n_points),
         rng.uniform(12, 40, n_points)], -1
    ).astype(np.float32)
    poses = np.stack(
        [np.asarray(se3.exp(jnp.asarray([c * 0.6, 0.02 * c, 0.0, 0.0, 0.02 * c, 0.0], jnp.float32)))
         for c in range(n_cams)]
    )
    oc, op, uvr = [], [], []
    for c in range(n_cams):
        pc = np.asarray(se3.transform(jnp.asarray(poses[c]), jnp.asarray(X)))
        u = np.array(camera.project_stereo(CAM, jnp.asarray(pc)))
        u += rng.normal(scale=0.2, size=u.shape)
        idx = np.where(pc[:, 2] > 1)[0]
        oc.append(np.full(len(idx), c))
        op.append(idx)
        uvr.append(u[idx])
    oc = np.concatenate(oc).astype(np.int32)
    op = np.concatenate(op).astype(np.int32)
    uvr = np.concatenate(uvr).astype(np.float32)
    O = len(oc)
    dT = rng.normal(scale=0.02, size=(n_cams, 6)).astype(np.float32)
    dT[0] = 0
    return poses, X, ba.BAProblem(
        Tcw=se3.retract(jnp.asarray(poses), jnp.asarray(dT)),
        pose_fixed=jnp.asarray(np.arange(n_cams) == 0),
        X=jnp.asarray(X + rng.normal(scale=0.15, size=X.shape).astype(np.float32)),
        point_fixed=jnp.zeros(n_points, bool),
        obs_cam=jnp.asarray(oc), obs_point=jnp.asarray(op),
        obs_uvr=jnp.asarray(uvr),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_stereo=jnp.ones(O, bool),
        obs_valid=jnp.ones(O, bool),
    )


class TestDistributedBA:
    @pytest.fixture(scope="class")
    def mesh(self):
        devs = np.asarray(jax.devices())
        assert len(devs) == 8, "conftest must force 8 CPU devices"
        return Mesh(devs, (distributed_ba.AXIS,))

    def test_converges_like_single_device(self, mesh, rng):
        poses_true, X_true, prob = make_problem(rng)
        Tcw_d, X_d = distributed_ba.distributed_ba(
            CAM, prob, mesh, n_iters=12, cg_iters=60
        )
        # Pose error vs ground truth after optimization
        for c in range(1, 8):
            e = np.asarray(se3.log(se3.compose(jnp.asarray(Tcw_d)[c], se3.inverse(jnp.asarray(poses_true[c])))))
            assert np.abs(e).max() < 0.01, (c, e)

    def test_matches_unsharded_step(self, mesh, rng):
        """One sharded GN step == one unsharded GN step (same math)."""
        _, _, prob = make_problem(rng, n_cams=4, n_points=200)
        prob_p = distributed_ba.pad_observations(prob, 8)
        step = distributed_ba.make_gn_step(CAM, mesh, cg_iters=25)
        T1, X1 = step(
            prob_p.Tcw, prob_p.X, prob_p.pose_fixed, prob_p.point_fixed,
            prob_p.obs_cam, prob_p.obs_point, prob_p.obs_uvr,
            prob_p.obs_inv_sigma2, prob_p.obs_stereo, prob_p.obs_valid,
            jnp.float32(1e-4),
        )
        mesh1 = Mesh(np.asarray(jax.devices())[:1], (distributed_ba.AXIS,))
        step1 = distributed_ba.make_gn_step(CAM, mesh1, cg_iters=25)
        T2, X2 = step1(
            prob_p.Tcw, prob_p.X, prob_p.pose_fixed, prob_p.point_fixed,
            prob_p.obs_cam, prob_p.obs_point, prob_p.obs_uvr,
            prob_p.obs_inv_sigma2, prob_p.obs_stereo, prob_p.obs_valid,
            jnp.float32(1e-4),
        )
        np.testing.assert_allclose(np.asarray(T1), np.asarray(T2), atol=1e-4)
        np.testing.assert_allclose(np.asarray(X1), np.asarray(X2), atol=5e-3)


class TestDistributedDenseBA:
    """The production distributed-GBA path: camera-sharded dense-plane LM
    (parallel/distributed_ba.optimize_dense), the entry GlobalBARunner
    dispatches when >1 device is visible."""

    @pytest.fixture(scope="class")
    def mesh(self):
        devs = np.asarray(jax.devices())
        assert len(devs) == 8, "conftest must force 8 CPU devices"
        return Mesh(devs, (distributed_ba.AXIS,))

    def _dense_problem(self, rng, n_cams=8, n_points=300):
        from test_ba_dense import flat_to_dense

        poses_true, X_true, prob = make_problem(rng, n_cams, n_points)
        return poses_true, flat_to_dense(prob, Fb=n_points)

    def test_single_device_mesh_is_exact(self, rng):
        """On a 1-device mesh all psums are identity, so the sharded
        program must reproduce the plain engine almost exactly — a
        regression guard that the collectives are placed correctly (any
        double/missing psum yields O(1) pose errors immediately). Not
        bit-exact: the tolerance-gated CG exit can stop one iteration
        apart between the two compiled programs when the residual sits at
        the threshold, so allow ~1e-3."""
        from corbslam.optim import ba_dense

        _, dense = self._dense_problem(rng)
        mesh1 = Mesh(np.asarray(jax.devices())[:1], (distributed_ba.AXIS,))
        res_s = distributed_ba.optimize_dense(
            CAM, dense, mesh1, n_iters=6, cg_iters=30, huber_iters=2)
        res_1 = ba_dense.optimize(
            CAM, dense, n_iters=6, cg_iters=30, huber_iters=2)
        np.testing.assert_allclose(
            np.asarray(res_s.Tcw), np.asarray(res_1.Tcw), atol=1e-3)

    def test_sharded_reaches_single_device_quality(self, mesh, rng):
        """8-way sharding changes f32 reduction order, which CG amplifies
        into different (equally valid) trajectories — so compare the
        OPTIMA, not the iterates: final costs must agree closely."""
        from corbslam.optim import ba_dense

        _, dense = self._dense_problem(rng)
        res_s = distributed_ba.optimize_dense(
            CAM, dense, mesh, n_iters=12, cg_iters=40, huber_iters=3)
        res_1 = ba_dense.optimize(
            CAM, dense, n_iters=12, cg_iters=40, huber_iters=3)
        c_s, c_1 = float(res_s.cost), float(res_1.cost)
        assert c_s < c_1 * 1.3 + 1e-3, (c_s, c_1)

    def test_sharded_converges_to_truth(self, mesh, rng):
        poses_true, dense = self._dense_problem(rng)
        res = distributed_ba.optimize_dense(
            CAM, dense, mesh, n_iters=12, cg_iters=40, huber_iters=3)
        for c in range(1, 8):
            e = np.asarray(se3.log(se3.compose(
                res.Tcw[c], se3.inverse(jnp.asarray(poses_true[c])))))
            assert np.abs(e).max() < 0.01, (c, e)

    def test_runner_uses_mesh_and_aborts(self, mesh, rng):
        """GlobalBARunner with a mesh runs the sharded entry and still
        honors the chunked-abort protocol (LoopClosing.cc:413-428)."""
        import test_loop as tl
        from corbslam.loop import gba as gba_mod

        m, gt, est, kf_c, kf_q = tl.build_loop_map(rng, drift_per_kf=0.01)
        runner = gba_mod.GlobalBARunner(
            tl.CAM, tl.CFG, n_iters=4, synchronous=True, mesh=mesh)
        runner.launch(m)
        m2 = runner.try_merge(m)
        assert runner.runs_finished == 1
        assert bool(jnp.isfinite(m2.kf.Tcw).all())
        assert m2 is not m
        runner2 = gba_mod.GlobalBARunner(
            tl.CAM, tl.CFG, n_iters=50, chunk=1, mesh=mesh)
        runner2.launch(m)
        runner2.abort()
        assert not runner2.busy()
