"""Unit tests for the SE3/Sim3/camera substrate (SURVEY.md §7.2 step 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.geometry import camera, se3, sim3


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(se3.R_from_quat(jnp.asarray(q, jnp.float32)))


class TestSO3:
    def test_exp_log_roundtrip(self, rng):
        # |phi| < pi: the roundtrip is only identity on the canonical chart.
        phi = (rng.normal(size=(64, 3)) * 0.7).astype(np.float32)
        R = se3.so3_exp(jnp.asarray(phi))
        phi2 = se3.so3_log(R)
        np.testing.assert_allclose(np.asarray(phi2), phi, atol=2e-5)

    def test_log_exp_roundtrip_random_R(self, rng):
        R = random_rotations(rng, 64)
        phi = se3.so3_log(jnp.asarray(R))
        R2 = se3.so3_exp(phi)
        np.testing.assert_allclose(np.asarray(R2), R, atol=1e-4)

    def test_small_angle(self):
        phi = jnp.array([[1e-9, 0, 0], [0, 0, 0]], jnp.float32)
        R = se3.so3_exp(phi)
        np.testing.assert_allclose(np.asarray(R[1]), np.eye(3), atol=1e-7)
        assert np.all(np.isfinite(np.asarray(se3.so3_log(R))))

    def test_near_pi(self):
        axis = np.array([0.3, -0.5, 0.81])
        axis /= np.linalg.norm(axis)
        for theta in [3.1, np.pi - 1e-4]:
            phi = (theta * axis).astype(np.float32)[None]
            R = se3.so3_exp(jnp.asarray(phi))
            phi2 = np.asarray(se3.so3_log(R))[0]
            np.testing.assert_allclose(phi2, phi[0], atol=5e-3)

    def test_orthonormal(self, rng):
        phi = rng.normal(size=(16, 3)).astype(np.float32)
        R = np.asarray(se3.so3_exp(jnp.asarray(phi)))
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (16, 1, 1)), atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), np.ones(16), atol=1e-5)


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = rng.normal(size=(64, 6)).astype(np.float32)
        xi[:, 3:] *= 0.7  # keep |phi| < pi for chart identifiability
        T = se3.exp(jnp.asarray(xi))
        xi2 = np.asarray(se3.log(T))
        np.testing.assert_allclose(xi2, xi, atol=5e-5)

    def test_inverse_compose(self, rng):
        xi = rng.normal(size=(32, 6)).astype(np.float32)
        T = se3.exp(jnp.asarray(xi))
        I = np.asarray(se3.compose(T, se3.inverse(T)))
        np.testing.assert_allclose(I, np.tile(np.eye(4), (32, 1, 1)), atol=1e-5)

    def test_transform_matches_matrix(self, rng):
        xi = rng.normal(size=(8, 6)).astype(np.float32)
        p = rng.normal(size=(8, 3)).astype(np.float32)
        T = se3.exp(jnp.asarray(xi))
        out = np.asarray(se3.transform(T, jnp.asarray(p)))
        Th = np.asarray(T)
        ph = np.concatenate([p, np.ones((8, 1))], axis=-1)
        expected = np.einsum("nij,nj->ni", Th, ph)[:, :3]
        np.testing.assert_allclose(out, expected, atol=1e-5)

    def test_retract_identity_tangent(self, rng):
        xi = rng.normal(size=(4, 6)).astype(np.float32)
        T = se3.exp(jnp.asarray(xi))
        T2 = se3.retract(T, jnp.zeros((4, 6), jnp.float32))
        np.testing.assert_allclose(np.asarray(T2), np.asarray(T), atol=1e-6)

    def test_quat_roundtrip(self, rng):
        R = random_rotations(rng, 64)
        q = se3.quat_from_R(jnp.asarray(R))
        R2 = np.asarray(se3.R_from_quat(q))
        np.testing.assert_allclose(R2, R, atol=1e-4)


class TestSim3:
    def test_exp_log_roundtrip(self, rng):
        xi = (rng.normal(size=(64, 7)) * np.array([1, 1, 1, 0.8, 0.8, 0.8, 0.3])).astype(np.float32)
        S = sim3.exp(jnp.asarray(xi))
        xi2 = np.asarray(sim3.log(S))
        np.testing.assert_allclose(xi2, xi, atol=2e-4)

    def test_compose_inverse(self, rng):
        xi = rng.normal(size=(16, 7)).astype(np.float32) * 0.5
        S = sim3.exp(jnp.asarray(xi))
        R, t, s = sim3.compose(S, sim3.inverse(S))
        np.testing.assert_allclose(np.asarray(R), np.tile(np.eye(3), (16, 1, 1)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(t), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(s), 1, atol=1e-5)

    def test_transform_matches_direct(self, rng):
        xi = rng.normal(size=(8, 7)).astype(np.float32) * 0.5
        S = sim3.exp(jnp.asarray(xi))
        p = rng.normal(size=(8, 3)).astype(np.float32)
        out = np.asarray(sim3.transform(S, jnp.asarray(p)))
        R, t, s = (np.asarray(x) for x in S)
        expected = s[:, None] * np.einsum("nij,nj->ni", R, p) + t
        np.testing.assert_allclose(out, expected, atol=1e-5)

    def test_se3_interop(self, rng):
        xi = rng.normal(size=(4, 6)).astype(np.float32)
        T = se3.exp(jnp.asarray(xi))
        S = sim3.from_se3(T)
        p = rng.normal(size=(4, 3)).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(sim3.transform(S, jnp.asarray(p))),
            np.asarray(se3.transform(T, jnp.asarray(p))),
            atol=1e-6,
        )


class TestCamera:
    @pytest.fixture
    def cam(self):
        # KITTI 00-02 intrinsics (ref: Examples/Stereo/KITTI00-02.yaml)
        return camera.Intrinsics.create(
            fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
            bf=386.1448, width=1241, height=376,
        )

    def test_project_backproject(self, cam, rng):
        depth = rng.uniform(1.0, 50.0, size=100).astype(np.float32)
        uv = np.stack(
            [rng.uniform(0, 1240, 100), rng.uniform(0, 375, 100)], axis=-1
        ).astype(np.float32)
        p = camera.backproject(cam, jnp.asarray(uv), jnp.asarray(depth))
        uv2 = np.asarray(camera.project(cam, p))
        np.testing.assert_allclose(uv2, uv, atol=1e-2)

    def test_stereo_disparity_positive(self, cam, rng):
        p = np.stack(
            [rng.normal(size=50) * 5, rng.normal(size=50) * 2, rng.uniform(2, 40, 50)],
            axis=-1,
        ).astype(np.float32)
        uvr = np.asarray(camera.project_stereo(cam, jnp.asarray(p)))
        disparity = uvr[:, 0] - uvr[:, 2]
        assert np.all(disparity > 0)
        np.testing.assert_allclose(disparity, np.asarray(cam.bf) / p[:, 2], rtol=1e-4)

    def test_undistort_identity_when_no_distortion(self, cam, rng):
        uv = np.stack(
            [rng.uniform(0, 1240, 50), rng.uniform(0, 375, 50)], axis=-1
        ).astype(np.float32)
        uv2 = np.asarray(camera.undistort_points(cam, jnp.asarray(uv)))
        np.testing.assert_allclose(uv2, uv, atol=1e-3)

    def test_undistort_inverts_distort(self):
        cam = camera.Intrinsics.create(
            fx=517.3, fy=516.5, cx=318.6, cy=255.3,
            dist=[0.26, -0.95, -0.0054, 0.0027, 1.16],  # TUM1-like
            width=640, height=480,
        )
        # Normalized grid points, distort then undistort.
        xs, ys = np.meshgrid(np.linspace(-0.3, 0.3, 7), np.linspace(-0.25, 0.25, 7))
        xy = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
        uv_true = np.stack(
            [xy[:, 0] * 517.3 + 318.6, xy[:, 1] * 516.5 + 255.3], -1
        )
        xyd = np.asarray(camera.distort(cam, jnp.asarray(xy)))
        uv_dist = np.stack([xyd[:, 0] * 517.3 + 318.6, xyd[:, 1] * 516.5 + 255.3], -1)
        uv_est = np.asarray(camera.undistort_points(cam, jnp.asarray(uv_dist), iters=10))
        np.testing.assert_allclose(uv_est, uv_true, atol=0.1)

    def test_triangulate(self, cam, rng):
        # Known 3D points observed from two poses.
        p_world = np.stack(
            [rng.normal(size=40) * 10, rng.normal(size=40) * 3, rng.uniform(5, 40, 40)],
            axis=-1,
        ).astype(np.float32)
        T1 = se3.identity((1,))[0]
        T2 = se3.exp(jnp.asarray([[0.5, 0.02, 0.01, 0.01, 0.05, 0.002]], jnp.float32))[0]
        P1 = camera.projection_matrix(cam, T1)
        P2 = camera.projection_matrix(cam, T2)
        uv1 = camera.project(cam, se3.transform(T1, jnp.asarray(p_world)))
        uv2 = camera.project(cam, se3.transform(T2, jnp.asarray(p_world)))
        X = np.asarray(camera.triangulate_linear(P1, P2, uv1, uv2))
        np.testing.assert_allclose(X, p_world, atol=0.05, rtol=0.01)

    def test_in_frustum(self, cam):
        Tcw = se3.identity()
        p = jnp.array([[0.0, 0.0, 10.0], [0.0, 0.0, -5.0], [100.0, 0.0, 1.0]], jnp.float32)
        # Normal convention: camera->point direction (mean viewing ray).
        normal = jnp.array([[0.0, 0.0, 1.0]] * 3, jnp.float32)
        ok, uv, _, _, _ = camera.in_frustum(
            cam, Tcw, p, jnp.full(3, 0.1), jnp.full(3, 100.0), normal
        )
        assert bool(ok[0]) and not bool(ok[1]) and not bool(ok[2])


class TestOrthonormalizeFast:
    def test_projects_back_to_so3(self, rng):
        R = random_rotations(rng, 16)
        E = rng.normal(size=(16, 3, 3)).astype(np.float32) * 0.02
        T = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
        T[:, :3, :3] = R + E
        T[:, :3, 3] = rng.normal(size=(16, 3))
        out = np.asarray(se3.orthonormalize_fast(jnp.asarray(T)))
        Ro = out[:, :3, :3]
        err = np.abs(Ro @ np.swapaxes(Ro, 1, 2) - np.eye(3)).max()
        assert err < 1e-5
        # translation untouched, rotation close to the perturbed input
        np.testing.assert_allclose(out[:, :3, 3], T[:, :3, 3], rtol=1e-6)
        assert np.abs(Ro - R).max() < 0.1

    def test_velocity_chain_stays_orthonormal(self, rng):
        """Regression: the per-frame velocity/predict chain
        (T_cur ∘ T_prev^-1 ∘ T_prev …) DOUBLES symmetric rotation error per
        round trip; without renormalization f32 rounding compounded ~2.5x
        per frame and destroyed stored keyframe rotations within ~150
        frames (found by tools/loop_e2e.py, round 3)."""
        T = jnp.asarray(np.eye(4, dtype=np.float32))
        prev = T
        vel = jnp.eye(4)
        step = se3.exp(jnp.asarray([0.1, 0.01, -0.05, 0.002, 0.035, 0.001]))
        for _ in range(120):
            pred = se3.compose(vel, prev)
            cur = se3.orthonormalize_fast(se3.compose(step, pred))
            vel = se3.compose(cur, se3.inverse(prev))
            prev = cur
        R = np.asarray(prev)[:3, :3]
        assert np.abs(R @ R.T - np.eye(3)).max() < 1e-5
