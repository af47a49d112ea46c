"""Pose-graph optimization tests: loop-closure correction on a drifted
circular trajectory — the exact scenario OptimizeEssentialGraph exists for."""

import jax.numpy as jnp
import numpy as np

from corbslam.geometry import se3, sim3
from corbslam.optim import pose_graph


def build_ring(n=40, drift_per_step=0.02, rng=None):
    """Ground-truth ring of poses + drifted odometry estimates.

    Returns (S_true list, S_est list) as world->kf Sim3 tuples."""
    true = []
    est = []
    T_acc_true = jnp.eye(4)
    T_acc_est = jnp.eye(4)
    step = np.asarray([0.5, 0.0, 0.0, 0.0, 2 * np.pi / n, 0.0], np.float32)
    for i in range(n):
        true.append(T_acc_true)
        est.append(T_acc_est)
        T_rel = se3.exp(jnp.asarray(step))
        noise = np.zeros(6, np.float32)
        if rng is not None:
            noise = (rng.normal(size=6) * drift_per_step).astype(np.float32)
        T_rel_noisy = se3.compose(se3.exp(jnp.asarray(noise)), T_rel)
        T_acc_true = se3.compose(T_rel, T_acc_true)
        T_acc_est = se3.compose(T_rel_noisy, T_acc_est)
    return true, est


class TestPoseGraph:
    def test_loop_closure_corrects_drift(self, rng):
        n = 40
        true, est = build_ring(n, drift_per_step=0.03, rng=rng)
        R = jnp.stack([se3.rotation(T) for T in est])
        t = jnp.stack([se3.translation(T) for T in est])
        s = jnp.ones(n)

        # Odometry edges from the DRIFTED estimates... no: odometry edges are
        # the noisy relative measurements themselves (consistent with est),
        # plus one loop edge carrying the TRUE relative pose 0 -> n-1.
        e_i, e_j, mR, mt, ms_ = [], [], [], [], []
        for i in range(n - 1):
            Si = sim3.from_se3(est[i])
            Sj = sim3.from_se3(est[i + 1])
            Sm = sim3.compose(Sj, sim3.inverse(Si))  # matches est exactly
            e_i.append(i); e_j.append(i + 1)
            mR.append(Sm[0]); mt.append(Sm[1]); ms_.append(Sm[2])
        # Loop edge with ground-truth relative Sim3
        Si = sim3.from_se3(true[0])
        Sj = sim3.from_se3(true[n - 1])
        Sm = sim3.compose(Sj, sim3.inverse(Si))
        e_i.append(0); e_j.append(n - 1)
        mR.append(Sm[0]); mt.append(Sm[1]); ms_.append(Sm[2])

        E = len(e_i)
        g = pose_graph.PoseGraph(
            R=R, t=t, s=s,
            fixed=jnp.asarray(np.arange(n) == 0),
            e_i=jnp.asarray(np.asarray(e_i, np.int32)),
            e_j=jnp.asarray(np.asarray(e_j, np.int32)),
            mR=jnp.stack(mR), mt=jnp.stack(mt), ms=jnp.stack(ms_),
            e_valid=jnp.ones(E, bool),
            e_weight=jnp.ones(E).at[E - 1].set(5.0),
        )
        (R2, t2, s2), costs = pose_graph.optimize(g, n_iters=15, cg_iters=40)

        # Drift at the loop end before optimization:
        err_before = float(jnp.linalg.norm(
            se3.translation(est[n - 1]) - se3.translation(true[n - 1])
        ))
        err_after = float(jnp.linalg.norm(t2[n - 1] - se3.translation(true[n - 1])))
        assert err_before > 0.2
        assert err_after < 0.35 * err_before
        # Costs decrease
        assert float(costs[-1]) < float(costs[0])
        # Scales stay near 1 (rigid problem)
        np.testing.assert_allclose(np.asarray(s2), 1.0, atol=0.05)

    def test_residual_zero_at_consistent_config(self, rng):
        true, _ = build_ring(10, 0.0)
        n = 10
        R = jnp.stack([se3.rotation(T) for T in true])
        t = jnp.stack([se3.translation(T) for T in true])
        s = jnp.ones(n)
        e_i = jnp.arange(n - 1, dtype=jnp.int32)
        e_j = e_i + 1
        Si = (R[e_i], t[e_i], s[e_i])
        Sj = (R[e_j], t[e_j], s[e_j])
        Sm = sim3.compose(Sj, sim3.inverse(Si))
        g = pose_graph.PoseGraph(
            R=R, t=t, s=s, fixed=jnp.zeros(n, bool).at[0].set(True),
            e_i=e_i, e_j=e_j, mR=Sm[0], mt=Sm[1], ms=Sm[2],
            e_valid=jnp.ones(n - 1, bool), e_weight=jnp.ones(n - 1),
        )
        r, Ji, Jj = pose_graph.linearize_edges(g)
        np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-4)
        assert np.isfinite(np.asarray(Ji)).all()
