"""Stereo rectification map tests (geometry/rectify.py).

Mirrors the reference's use of cv::initUndistortRectifyMap in
corbslam_client/Examples/Stereo/stereo_euroc.cc.
"""

import numpy as np
import jax.numpy as jnp

from corbslam.geometry import camera as cam_mod
from corbslam.geometry import rectify


def test_rectified_to_raw_inverse_consistency():
    """raw = rectified_to_raw(p); undistorting raw and re-projecting through
    R,P must recover p (independent fixed-point undistort vs forward map)."""
    K = rectify.EUROC_LEFT_K
    D = rectify.EUROC_LEFT_D
    R = rectify.EUROC_LEFT_R
    P = rectify.EUROC_P
    rng = np.random.default_rng(0)
    uv_rect = rng.uniform([100, 100], [650, 380], size=(256, 2))
    raw = rectify.rectified_to_raw(K, D, R, P, uv_rect)

    # Independent inverse: iterative undistort with the same radtan model.
    cam = cam_mod.Intrinsics.create(
        fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
        dist=(D[0], D[1], D[2], D[3], 0.0), width=752, height=480,
    )
    und = np.asarray(cam_mod.undistort_points(cam, jnp.asarray(raw), iters=20))
    xn = (und[:, 0] - K[0, 2]) / K[0, 0]
    yn = (und[:, 1] - K[1, 2]) / K[1, 1]
    ray = np.stack([xn, yn, np.ones_like(xn)], -1) @ R.T
    u = P[0, 0] * ray[:, 0] / ray[:, 2] + P[0, 2]
    v = P[1, 1] * ray[:, 1] / ray[:, 2] + P[1, 2]
    err = np.hypot(u - uv_rect[:, 0], v - uv_rect[:, 1])
    assert float(err.max()) < 0.1, float(err.max())


def test_remap_identity_map_is_noop():
    img = np.random.default_rng(1).uniform(0, 255, (48, 64)).astype(np.float32)
    v, u = np.mgrid[0:48, 0:64].astype(np.float32)
    m = rectify.RectifyMap(u, v)
    out = m.remap(img)
    np.testing.assert_allclose(out, img, atol=1e-4)


def test_remap_shifts_image():
    img = np.zeros((32, 32), np.float32)
    img[10, 12] = 100.0
    v, u = np.mgrid[0:32, 0:32].astype(np.float32)
    m = rectify.RectifyMap(u + 2.0, v + 3.0)  # sample from (x+2, y+3)
    out = m.remap(img)
    assert out[7, 10] == 100.0


def test_euroc_maps_build_and_are_in_bounds():
    left, right = rectify.euroc_rectify_maps()
    assert left.map_x.shape == (480, 752)
    # The bulk of the rectified frame must sample inside the raw image.
    inside = (
        (left.map_x > -40) & (left.map_x < 792)
        & (left.map_y > -40) & (left.map_y < 520)
    )
    assert inside.mean() > 0.98
    # Rectified principal ray should land near the raw principal point.
    cx, cy = 367, 252
    assert abs(left.map_x[cy, cx] - 367.215) < 12.0
    assert abs(left.map_y[cy, cx] - 248.375) < 12.0
    assert abs(right.map_x[cy, cx] - 379.999) < 15.0


def test_tum_camera_has_distortion_and_frame_undistorts():
    from corbslam.io import datasets

    cam = datasets.tum_camera(1)
    assert cam.dist[0] != 0.0
    # Keypoint undistortion round-trips through the distortion model.
    uv = jnp.asarray([[200.0, 150.0], [400.0, 300.0], [320.0, 240.0]])
    und = cam_mod.undistort_points(cam, uv, iters=20)
    xn = (und[..., 0] - cam.cx) / cam.fx
    yn = (und[..., 1] - cam.cy) / cam.fy
    redist = cam_mod.distort(cam, jnp.stack([xn, yn], -1))
    u = redist[..., 0] * cam.fx + cam.cx
    v = redist[..., 1] * cam.fy + cam.cy
    err = np.hypot(np.asarray(u - uv[:, 0]), np.asarray(v - uv[:, 1]))
    assert float(err.max()) < 0.05
