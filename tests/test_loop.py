"""Loop closing tests: Sim3 verification between keyframes, window
correction, essential-graph optimization, async GBA with abort — the
capability set of the reference's LoopClosing thread (LoopClosing.cc) on
synthetic maps with known ground truth (SURVEY.md §4 test strategy)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from corbslam.config import CapacityConfig, OrbConfig, SlamConfig
from corbslam.geometry import camera, se3
from corbslam.loop import gba as gba_mod
from corbslam.loop import loop_closing as lc
from corbslam.mapstate import mapstate as ms

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


def random_descs(rng, n):
    return jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))


def build_loop_map(rng, n_kf=12, n_pts_per=60, drift_per_kf=0.02,
                   mono=False, scale_drift=1.0):
    """A straight out-and-back trajectory whose estimated poses accumulate
    drift; the first and last keyframes revisit the same scene points (the
    last KF observes DUPLICATE copies of KF0's landmarks, positioned
    consistently with its drifted pose — exactly the state the reference's
    loop closer faces).

    `mono=True` strips stereo depth (uright=-1, depth=0) from every
    keyframe. `scale_drift=k` additionally scales the QUERY side's local
    structure by k about its camera (duplicate landmark camera-frame
    coordinates multiplied by k) — the monocular scale-drift state Sim3
    loop closure exists for (ref: LoopClosing.cc:233 mbFixScale=false)."""
    m = ms.empty(CFG.capacity)
    F = CFG.capacity.max_features

    # World points in front of the start pose.
    X0 = np.stack([
        rng.uniform(-4, 4, n_pts_per),
        rng.uniform(-3, 3, n_pts_per),
        rng.uniform(6, 14, n_pts_per),
    ], -1).astype(np.float32)
    desc0 = random_descs(rng, n_pts_per)

    # GT: move +x and return. Estimated poses drift in x.
    gt, est = [], []
    for i in range(n_kf):
        x = 2.0 * np.sin(np.pi * i / (n_kf - 1))  # out and back
        T_gt = np.eye(4, dtype=np.float32)
        T_gt[0, 3] = -x  # Tcw: camera at +x means world shifts -x
        gt.append(T_gt)
        T_est = T_gt.copy()
        T_est[0, 3] += drift_per_kf * i  # accumulated drift
        est.append(T_est)

    # Mid-trajectory points (unique per middle keyframe) so every KF has
    # observations; KF0 and KF last share the scene.
    def insert_kf(m, T_est, pts_world, descs, mp_rows):
        p_cam = (T_est[:3, :3] @ pts_world.T).T + T_est[:3, 3]
        uv = np.stack([
            CAM.fx * p_cam[:, 0] / p_cam[:, 2] + CAM.cx,
            CAM.fy * p_cam[:, 1] / p_cam[:, 2] + CAM.cy,
        ], -1).astype(np.float32)
        k = pts_world.shape[0]
        xy = np.zeros((F, 2), np.float32)
        xy[:k] = uv
        desc = np.zeros((F, 32), np.uint8)
        desc[:k] = np.asarray(descs)
        depth = np.zeros(F, np.float32)
        ur = np.full(F, -1.0, np.float32)
        if not mono:
            depth[:k] = p_cam[:, 2]
            ur[:k] = uv[:, 0] - CAM.bf / p_cam[:, 2]
        fvalid = np.zeros(F, bool)
        fvalid[:k] = True
        mp_idx = np.full(F, ms.NO_MP, np.int32)
        mp_idx[:k] = mp_rows
        m, row = ms.insert_keyframe(
            m, jnp.asarray(T_est), jnp.asarray(xy),
            jnp.zeros(F, jnp.int32), jnp.zeros(F, jnp.float32),
            jnp.asarray(desc), jnp.asarray(ur), jnp.asarray(depth),
            jnp.asarray(fvalid), jnp.asarray(mp_idx),
            frame_id=row_id[0], timestamp=0.0,
        )
        row_id[0] += 1
        return m, int(row)

    row_id = [0]

    def add_points(m, pos, desc, ref_kf, T_ref):
        # Realistic scale bands: the pipeline sets max_dist ~ viewing
        # distance at the observing octave (MapPoint::UpdateNormalAndDepth);
        # PredictScale relies on that.
        k = pos.shape[0]
        p_cam = (T_ref[:3, :3] @ np.asarray(pos).T).T + T_ref[:3, 3]
        dist = np.linalg.norm(p_cam, axis=-1).astype(np.float32)
        ctr = -T_ref[:3, :3].T @ T_ref[:3, 3]
        normal = np.asarray(pos) - ctr
        normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
        m, rows = ms.add_map_points(
            m, jnp.asarray(pos), desc,
            normal=jnp.asarray(normal),
            # Pipeline convention (insert_keyframe_with_points): max_dist =
            # viewing distance * 1.2^octave; all test features are octave 0.
            min_dist=jnp.asarray(dist / 1.2 ** (CFG.orb.n_levels - 1)),
            max_dist=jnp.asarray(dist),
            ref_kf=ref_kf, create=jnp.ones(k, bool),
        )
        return m, np.asarray(rows)

    # KF0: accurate points.
    m, rows0 = add_points(m, X0, desc0, 0, est[0])
    m, r0 = insert_kf(m, est[0], X0, desc0, rows0)

    # Middle KFs: their own points (visible from their pose), consistent
    # with the DRIFTED estimate (as a real mapper would place them).
    for i in range(1, n_kf - 1):
        Xi_gt = X0 + np.asarray([2.0 * np.sin(np.pi * i / (n_kf - 1)), 0, 0],
                                np.float32)
        T_e, T_g = est[i], gt[i]
        # position consistent with est pose: X_est = T_est^-1 T_gt X_gt
        p_cam = (T_g[:3, :3] @ Xi_gt.T).T + T_g[:3, 3]
        Rinv = T_e[:3, :3].T
        Xi_est = (Rinv @ (p_cam - T_e[:3, 3]).T).T
        di = random_descs(rng, n_pts_per)
        m, rowsi = add_points(m, Xi_est.astype(np.float32), di, i, est[i])
        m, _ = insert_kf(m, est[i], Xi_est, di, rowsi)

    # Last KF: revisits KF0's scene — duplicate landmark copies placed
    # consistently with ITS drifted pose, same descriptors as KF0's points.
    # Under scale drift the query's local structure sits at k x the true
    # camera-frame distance (projecting to the SAME pixels — central
    # projection is invariant to radial scaling about the camera).
    T_e, T_g = est[-1], gt[-1]
    p_cam = scale_drift * ((T_g[:3, :3] @ X0.T).T + T_g[:3, 3])
    X_dup = (T_e[:3, :3].T @ (p_cam - T_e[:3, 3]).T).T.astype(np.float32)
    m, rows_dup = add_points(m, X_dup, desc0, n_kf - 1, est[-1])
    m, r_last = insert_kf(m, est[-1], X_dup, desc0, rows_dup)

    return m, np.stack(gt), np.stack(est), r0, r_last


class TestComputeSim3:
    def test_recovers_relative_pose(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(rng)
        key = jax.random.PRNGKey(0)
        sb = lc.compute_sim3(CAM, m, kf_q, kf_c, key, CFG, fix_scale=True)
        assert bool(sb.ok), (int(sb.n_bow), int(sb.n_inliers), int(sb.n_total))
        # Expected S_qc = T_q_gt ∘ T_c_est^-1 (candidate believed accurate).
        S_exp = np.asarray(gt[-1]) @ np.linalg.inv(np.asarray(est[0]))
        assert np.allclose(np.asarray(sb.R), S_exp[:3, :3], atol=5e-3)
        assert np.allclose(np.asarray(sb.t), S_exp[:3, 3], atol=5e-2)
        assert abs(float(sb.s) - 1.0) < 1e-6  # fix_scale

    def test_rejects_unrelated_keyframes(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(rng)
        key = jax.random.PRNGKey(1)
        # Middle keyframe shares no landmarks with the last one.
        sb = lc.compute_sim3(CAM, m, kf_q, 5, key, CFG, fix_scale=True)
        assert not bool(sb.ok)


class TestLoopCorrection:
    def test_close_loop_restores_poses_and_merges_points(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(rng)
        key = jax.random.PRNGKey(0)
        sb = lc.compute_sim3(CAM, m, kf_q, kf_c, key, CFG, fix_scale=True)
        assert bool(sb.ok)

        n_valid_before = int(jnp.sum(m.mp.valid))
        closer = lc.LoopCloser.__new__(lc.LoopCloser)  # skip vocab setup
        closer.cam, closer.cfg = CAM, CFG
        closer.loops = lc.LoopEdges.empty()
        closer.n_loops = 0
        closer.gba_runner = None
        closer.stats = lc.LoopCloserStats()
        closer.consistent_groups = []
        closer.last_loop_kf = -1

        m2 = closer.close_loop(m, kf_q, kf_c, sb)

        # Query pose pulled to ground truth (drift removed).
        T_q = np.asarray(m2.kf.Tcw[kf_q])
        err_after = np.linalg.norm(T_q[:3, 3] - gt[-1][:3, 3])
        err_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
        assert err_after < 0.3 * err_before, (err_before, err_after)

        # Middle poses improved too (pose graph distributed the correction).
        def total_err(mm):
            T = np.asarray(mm.kf.Tcw[: len(gt)])
            return np.linalg.norm(T[:, :3, 3] - gt[:, :3, 3], axis=-1).sum()

        assert total_err(m2) < 0.6 * np.linalg.norm(
            est[:, :3, 3] - gt[:, :3, 3], axis=-1
        ).sum()

        # Duplicate landmarks got fused (SearchAndFuse).
        n_valid_after = int(jnp.sum(m2.mp.valid))
        assert n_valid_after < n_valid_before


class TestSpanningParents:
    def test_chain_stays_within_client(self, rng):
        """In a merged global map with interleaved client rows the spanning
        chain must follow per-client predecessors — no cross-client
        zero-residual odometry edges (ref spanning tree semantics,
        KeyFrame.h:140-150; Optimizer.cc:840)."""
        m = ms.empty(CFG.capacity)
        clients = jnp.asarray(
            [1, 1, 2, 1, 2, 2, 1, 3, 2, 3], jnp.int32)
        n = clients.shape[0]
        valid = jnp.zeros(CFG.capacity.max_keyframes, bool).at[:n].set(True)
        valid = valid.at[4].set(False)  # a culled row mid-sequence
        kf = m.kf._replace(
            valid=valid,
            client=m.kf.client.at[:n].set(clients),
        )
        m = m._replace(kf=kf, n_kf=jnp.int32(n))
        parent = np.asarray(lc.spanning_parents(m))
        cl = np.asarray(m.kf.client)
        val = np.asarray(m.kf.valid)
        for i in range(n):
            if not val[i]:
                assert parent[i] == -1
                continue
            same = [j for j in range(i) if val[j] and cl[j] == cl[i]]
            expect = max(same) if same else -1
            assert parent[i] == expect, (i, parent[i], expect)
        assert (parent[n:] == -1).all()


class TestGbaMergeBack:
    def test_chain_and_cross_client_propagation(self, rng):
        """Keyframes created DURING a GBA run must move by their spanning
        PARENT's correction, chained (ref LoopClosing.cc:685-755), and a
        client with no snapshot ancestor must not move at all."""
        m, gt, est, kf_c, kf_q = build_loop_map(rng)
        n_snap_kf, n_snap_mp = m.n_kf, m.n_mp
        Tcw_opt = np.asarray(m.kf.Tcw).copy()
        Tcw_opt[: int(n_snap_kf), 0, 3] += 1.0

        F = CFG.capacity.max_features
        zeros = dict(
            xy=m.kf.xy[0], octave=m.kf.octave[0], angle=m.kf.angle[0],
            desc=m.kf.desc[0], uright=m.kf.uright[0], depth=m.kf.depth[0],
            fvalid=m.kf.fvalid[0],
        )
        # A chain of two new keyframes for client 0 (the map's client).
        T_a = np.eye(4, dtype=np.float32); T_a[0, 3] = 5.0
        T_b = np.eye(4, dtype=np.float32); T_b[0, 3] = 7.0
        m2, row_a = ms.insert_keyframe(
            m, jnp.asarray(T_a), zeros["xy"], zeros["octave"], zeros["angle"],
            zeros["desc"], zeros["uright"], zeros["depth"], zeros["fvalid"],
            jnp.full(F, ms.NO_MP, jnp.int32), frame_id=90, timestamp=1.0)
        m2, row_b = ms.insert_keyframe(
            m2, jnp.asarray(T_b), zeros["xy"], zeros["octave"], zeros["angle"],
            zeros["desc"], zeros["uright"], zeros["depth"], zeros["fvalid"],
            jnp.full(F, ms.NO_MP, jnp.int32), frame_id=91, timestamp=1.1)
        # A new keyframe of a DIFFERENT client (no snapshot ancestor).
        T_c = np.eye(4, dtype=np.float32); T_c[1, 3] = 3.0
        m2, row_c = ms.insert_keyframe(
            m2, jnp.asarray(T_c), zeros["xy"], zeros["octave"], zeros["angle"],
            zeros["desc"], zeros["uright"], zeros["depth"], zeros["fvalid"],
            jnp.full(F, ms.NO_MP, jnp.int32), frame_id=92, timestamp=1.2,
            client=7)

        m3 = gba_mod.merge_gba_result(
            m2, jnp.asarray(Tcw_opt), m2.mp.pos, n_snap_kf, n_snap_mp)
        # Identity-rotation poses: right-delta = pure +1.0 x translation,
        # applied through the chain a -> b.
        assert np.allclose(np.asarray(m3.kf.Tcw[int(row_a)])[0, 3], 6.0,
                           atol=1e-5)
        assert np.allclose(np.asarray(m3.kf.Tcw[int(row_b)])[0, 3], 8.0,
                           atol=1e-5)
        # Foreign-client row without snapshot ancestor: unchanged.
        assert np.allclose(np.asarray(m3.kf.Tcw[int(row_c)]), T_c, atol=1e-6)


class TestEssentialGraphUnit:
    def test_zero_drift_is_stationary(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(rng, drift_per_kf=0.0)
        loops = lc.LoopEdges.empty().add(
            0, kf_c, kf_q,
            jnp.eye(3), jnp.zeros(3), jnp.float32(1.0),
        )
        # GT loop measurement: S_qc = T_q ∘ T_c^-1.
        S = np.asarray(gt[-1]) @ np.linalg.inv(np.asarray(gt[0]))
        loops = lc.LoopEdges.empty().add(
            0, kf_c, kf_q, jnp.asarray(S[:3, :3]), jnp.asarray(S[:3, 3]),
            jnp.float32(1.0),
        )
        m2, costs = lc.optimize_essential_graph(
            m, loops, kf_c, m.kf.Tcw, CFG, n_iters=5
        )
        moved = np.abs(np.asarray(m2.kf.Tcw[: len(gt)]) - est).max()
        assert moved < 1e-3, moved


class TestGlobalBA:
    def test_gba_reduces_drift_sync(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(rng, drift_per_kf=0.01)
        runner = gba_mod.GlobalBARunner(CAM, CFG, n_iters=10, synchronous=True)
        prob0 = gba_mod.build_global_problem(m, CFG)
        runner.launch(m)
        m2 = runner.try_merge(m)
        prob1 = gba_mod.build_global_problem(m2, CFG)
        from corbslam.optim import ba

        def cost(p):
            res = ba.optimize(CAM, p, n_iters=1, cg_iters=1, huber_iters=0)
            return float(res.cost)

        assert cost(prob1) < cost(prob0)
        assert runner.runs_finished == 1

    def test_gba_abort(self, rng):
        m, *_ = build_loop_map(rng)
        runner = gba_mod.GlobalBARunner(CAM, CFG, n_iters=50, chunk=1)
        runner.launch(m)
        runner.abort()
        assert not runner.busy()
        m2 = runner.try_merge(m)  # no result: map unchanged object-wise
        assert m2 is m

    def test_merge_propagates_to_new_keyframes(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(rng)
        n_snap_kf, n_snap_mp = m.n_kf, m.n_mp
        # Optimized poses: shift every snapshot KF by +1 in x (a synthetic
        # "GBA result"); a keyframe added after the snapshot should follow
        # via the anchor delta.
        Tcw_opt = np.asarray(m.kf.Tcw).copy()
        Tcw_opt[: int(n_snap_kf), 0, 3] += 1.0
        F = CFG.capacity.max_features
        m2, new_row = ms.insert_keyframe(
            m, jnp.asarray(est[-1]),
            m.kf.xy[kf_q], m.kf.octave[kf_q], m.kf.angle[kf_q],
            m.kf.desc[kf_q], m.kf.uright[kf_q], m.kf.depth[kf_q],
            m.kf.fvalid[kf_q], jnp.full(F, ms.NO_MP, jnp.int32),
            frame_id=99, timestamp=1.0,
        )
        m3 = gba_mod.merge_gba_result(
            m2, jnp.asarray(Tcw_opt), m2.mp.pos, n_snap_kf, n_snap_mp
        )
        assert np.allclose(
            np.asarray(m3.kf.Tcw[int(new_row)])[0, 3], est[-1][0, 3] + 1.0,
            atol=1e-5,
        )


class TestMonoScaleDriftLoop:
    """Monocular loop closure with SCALE drift — the case Sim3 (fix_scale=
    False) exists for (ref: LoopClosing.cc:233 mbFixScale=false; VERDICT r4
    missing #6). The query side's local structure is 12% larger than truth;
    the loop must estimate s != 1 and correct_window + essential graph must
    restore both the query pose AND the metric scale of its landmarks."""

    K_DRIFT = 1.12

    def _closed(self, rng):
        m, gt, est, kf_c, kf_q = build_loop_map(
            rng, mono=True, scale_drift=self.K_DRIFT)
        key = jax.random.PRNGKey(0)
        sb = lc.compute_sim3(CAM, m, kf_q, kf_c, key, CFG, fix_scale=False)
        return m, gt, est, kf_c, kf_q, sb

    def test_scale_recovered(self, rng):
        m, gt, est, kf_c, kf_q, sb = self._closed(rng)
        assert bool(sb.ok), (int(sb.n_bow), int(sb.n_inliers), int(sb.n_total))
        # The estimate rides noisy duplicate positions (drift 0.02/KF) and
        # XLA:CPU's nondeterministic threaded reductions jitter the RANSAC
        # consensus; demand the right BALLPARK (clearly != 1, within ~5%
        # of truth) — the correction-quality test below pins the rest.
        assert abs(float(sb.s) - self.K_DRIFT) < 0.06, float(sb.s)
        assert float(sb.s) > 1.04, float(sb.s)

    def test_close_loop_corrects_pose_and_scale(self, rng):
        m, gt, est, kf_c, kf_q, sb = self._closed(rng)
        assert bool(sb.ok)
        closer = lc.LoopCloser.__new__(lc.LoopCloser)
        closer.cam, closer.cfg = CAM, CFG
        closer.loops = lc.LoopEdges.empty()
        closer.n_loops = 0
        closer.gba_runner = None
        closer.stats = lc.LoopCloserStats()
        closer.consistent_groups = []
        closer.last_loop_kf = -1
        # Duplicate landmark rows anchored at the query (ref_kf == kf_q).
        dup_rows = np.nonzero(
            np.asarray(m.mp.valid) & (np.asarray(m.mp.ref_kf) == kf_q))[0]
        pos_before = np.asarray(m.mp.pos)[dup_rows]

        m2 = closer.close_loop(m, kf_q, kf_c, sb)

        T_q = np.asarray(m2.kf.Tcw[kf_q])
        err_after = np.linalg.norm(T_q[:3, 3] - gt[-1][:3, 3])
        err_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
        assert err_after < 0.5 * err_before, (err_before, err_after)

        # The query's landmarks (scale-drifted by K before) now sit at the
        # true positions: scale error removed. Note fuse merges some
        # duplicates into the candidate's (accurate) copies; restrict to
        # rows still valid and still anchored at the query.
        still = np.asarray(m2.mp.valid)[dup_rows]
        if still.sum() >= 10:
            pos_after = np.asarray(m2.mp.pos)[dup_rows[still]]
            # true camera-frame distance vs corrected camera-frame distance
            Tq2 = np.asarray(m2.kf.Tcw[kf_q])
            d_after = np.linalg.norm(
                (Tq2[:3, :3] @ pos_after.T).T + Tq2[:3, 3], axis=1)
            Tg = gt[-1]
            # distances of the TRUE structure from the gt camera
            d_true = np.linalg.norm(
                (Tg[:3, :3] @ pos_before[still].T).T + Tg[:3, 3],
                axis=1) / self.K_DRIFT
            ratio = np.median(d_after / d_true)
            assert abs(ratio - 1.0) < 0.05, ratio
