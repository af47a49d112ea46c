"""Synthetic imagery + scenes for tests and benchmarks.

The reference validates on KITTI/TUM/EuRoC replays (SURVEY.md §4); this
container has no datasets and zero egress, so the framework ships a
procedural substitute: band-limited random textures, homography/projective
warps, and a textured-plane 3-D world that renders consistent stereo pairs
along a camera trajectory — enough signal for FAST/BRIEF/matching/tracking
to behave like they do on real imagery, with exact ground truth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import camera as cam_mod
from ..geometry import se3

_HI = jax.lax.Precision.HIGHEST


def random_texture(h: int, w: int, seed: int = 0, octaves: int = 4) -> np.ndarray:
    """Multi-octave smoothed noise in [0, 255], strong local contrast."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        layer = rng.normal(size=(sh, sw)).astype(np.float32)
        layer = np.asarray(jax.image.resize(jnp.asarray(layer), (h, w), "bilinear"))
        img += layer * (2.0 ** -o)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def bilinear_sample(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation with clamping. img [H, W]; ys/xs any shape."""
    h, w = img.shape
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    dx = xs - x0
    dy = ys - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    flat = img.reshape(-1)
    v00 = flat[y0 * w + x0]
    v01 = flat[y0 * w + x1]
    v10 = flat[y1 * w + x0]
    v11 = flat[y1 * w + x1]
    return (
        v00 * (1 - dy) * (1 - dx)
        + v01 * (1 - dy) * dx
        + v10 * dy * (1 - dx)
        + v11 * dy * dx
    )


def warp_homography(img: jnp.ndarray, H: jnp.ndarray, out_hw) -> jnp.ndarray:
    """Warp by 3x3 homography mapping OUTPUT pixel -> SOURCE pixel."""
    oh, ow = out_hw
    yy = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 1)
    ones = jnp.ones_like(xx)
    pts = jnp.stack([xx, yy, ones], axis=0).reshape(3, -1)
    src = jnp.matmul(H, pts, precision=_HI)
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    return bilinear_sample(img, sy, sx).reshape(oh, ow)


class PlanarWorld:
    """A textured ground-like plane rendered from arbitrary camera poses.

    Plane: z = plane_dist in some world frame tilt; texture coordinates are a
    scaled orthographic chart of the plane. Rendering a view = homography
    warp of the master texture, so stereo pairs and sequences are exactly
    geometrically consistent (with known ground-truth poses and depth).
    """

    def __init__(
        self,
        cam: cam_mod.Intrinsics,
        texture_size: int = 4096,
        plane_dist: float = 12.0,
        texture_scale: float = 50.0,  # pixels per world unit on the plane
        seed: int = 0,
    ):
        self.cam = cam
        self.plane_dist = float(plane_dist)
        self.texture_scale = float(texture_scale)
        self.tex = jnp.asarray(random_texture(texture_size, texture_size, seed))
        self.tex_size = texture_size

    def _plane_to_tex(self):
        """World plane point (x, y, plane_dist) -> texture pixel (tx, ty)."""
        s = self.texture_scale
        c = self.tex_size / 2.0
        return s, c

    def render(self, Tcw: jnp.ndarray) -> jnp.ndarray:
        """Render the view from camera pose Tcw (world->cam). [H, W] f32."""
        cam = self.cam
        K = cam.K
        # Output pixel -> ray -> intersect plane z=d in WORLD frame.
        # p_cam = z * K^-1 u ; p_world = Rwc p_cam + twc.
        Twc = se3.inverse(Tcw)
        R = se3.rotation(Twc)
        t = se3.translation(Twc)
        Kinv = jnp.linalg.inv(K)
        h, w = cam.height, cam.width
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        ones = jnp.ones_like(xx)
        rays = jnp.einsum("ij,jhw->ihw", Kinv, jnp.stack([xx, yy, ones]),
                          precision=_HI)
        dirs = jnp.einsum("ij,jhw->ihw", R, rays, precision=_HI)  # world-frame directions
        # Intersect with plane z = plane_dist: t*dz + tz = d
        denom = dirs[2]
        lam = (self.plane_dist - t[2]) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        px = t[0] + lam * dirs[0]
        py = t[1] + lam * dirs[1]
        s, c = self._plane_to_tex()
        tx = px * s + c
        ty = py * s + c
        img = bilinear_sample(self.tex, ty, tx)
        # Rays that miss the plane (lam <= 0) render as flat gray.
        return jnp.where(lam > 0, img, 128.0)

    def render_stereo(self, Tcw: jnp.ndarray):
        """(left, right) pair; right camera offset by baseline along +x."""
        b = self.cam.baseline
        T_rl = se3.from_Rt(jnp.eye(3), jnp.array([-b, 0.0, 0.0]))
        return self.render(Tcw), self.render(se3.compose(T_rl, Tcw))

    def depth(self, Tcw: jnp.ndarray) -> jnp.ndarray:
        """Ground-truth depth map for a view (for RGB-D simulation)."""
        cam = self.cam
        Twc = se3.inverse(Tcw)
        R = se3.rotation(Twc)
        t = se3.translation(Twc)
        Kinv = jnp.linalg.inv(cam.K)
        h, w = cam.height, cam.width
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        ones = jnp.ones_like(xx)
        rays = jnp.einsum("ij,jhw->ihw", Kinv, jnp.stack([xx, yy, ones]),
                          precision=_HI)
        dirs = jnp.einsum("ij,jhw->ihw", R, rays, precision=_HI)
        denom = dirs[2]
        lam = (self.plane_dist - t[2]) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        # depth along camera z = lam * (R^T dirs)_z ... by construction
        # p_cam = lam * rays (camera frame), so z = lam * rays_z = lam.
        return jnp.where(lam > 0, lam * rays[2], 0.0)


class MultiPlaneWorld:
    """Non-planar 3-D validation world: N textured planes composited by
    z-buffer, with optional per-frame photometric noise.

    Addresses the planar-world degeneracy (a single plane is degenerate for
    F-matrix init and trivially texture-rich): real 3-D structure, depth
    discontinuities, and a room layout that supports closed-loop
    trajectories. Plane i is n_i . p = d_i with an orthonormal in-plane
    chart (u_i, v_i) mapping world points to its own texture.
    """

    def __init__(self, cam: cam_mod.Intrinsics, planes, texture_size: int = 2048,
                 texture_scale: float = 50.0, noise_std: float = 0.0,
                 seed: int = 0):
        """planes: list of (normal [3], offset d, chart_origin [3])."""
        self.cam = cam
        self.texture_scale = float(texture_scale)
        self.noise_std = float(noise_std)
        self.tex_size = texture_size
        n_list, d_list, o_list, u_list, v_list, tex = [], [], [], [], [], []
        for i, (n, d, o) in enumerate(planes):
            n = np.asarray(n, np.float32)
            n = n / np.linalg.norm(n)
            a = np.array([1.0, 0.0, 0.0], np.float32)
            if abs(n[0]) > 0.9:
                a = np.array([0.0, 1.0, 0.0], np.float32)
            u = np.cross(n, a); u /= np.linalg.norm(u)
            v = np.cross(n, u)
            n_list.append(n); d_list.append(float(d))
            o_list.append(np.asarray(o, np.float32))
            u_list.append(u); v_list.append(v)
            tex.append(random_texture(texture_size, texture_size,
                                      seed * 131 + i))
        self.n = jnp.asarray(np.stack(n_list))        # [P, 3]
        self.d = jnp.asarray(np.asarray(d_list))      # [P]
        self.o = jnp.asarray(np.stack(o_list))        # [P, 3]
        self.u = jnp.asarray(np.stack(u_list))        # [P, 3]
        self.v = jnp.asarray(np.stack(v_list))        # [P, 3]
        self.tex = jnp.asarray(np.stack(tex))         # [P, S, S]
        self._noise_seed = seed

    @staticmethod
    def room(cam: cam_mod.Intrinsics, half: float = 14.0, height: float = 3.0,
             noise_std: float = 0.0, seed: int = 0,
             texture_scale: float = 60.0) -> "MultiPlaneWorld":
        """A closed box room (4 walls + floor + ceiling): loop trajectories
        that circle inside it re-observe the start view — the loop-closure
        validation scene."""
        h = half
        planes = [
            ([0.0, 0.0, -1.0], -h, [0.0, 0.0, h]),    # front wall  z=+h
            ([0.0, 0.0, 1.0], -h, [0.0, 0.0, -h]),    # back wall   z=-h
            ([1.0, 0.0, 0.0], -h, [-h, 0.0, 0.0]),    # left wall   x=-h
            ([-1.0, 0.0, 0.0], -h, [h, 0.0, 0.0]),    # right wall  x=+h
            ([0.0, -1.0, 0.0], -height, [0.0, height, 0.0]),   # floor y=+height
            ([0.0, 1.0, 0.0], -height, [0.0, -height, 0.0]),   # ceiling
        ]
        return MultiPlaneWorld(cam, planes, noise_std=noise_std, seed=seed,
                               texture_scale=texture_scale)

    def _render_depth(self, Tcw: jnp.ndarray):
        cam = self.cam
        Twc = se3.inverse(Tcw)
        R = se3.rotation(Twc)
        t = se3.translation(Twc)
        Kinv = jnp.linalg.inv(cam.K)
        h, w = cam.height, cam.width
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        ones = jnp.ones_like(xx)
        rays = jnp.einsum("ij,jhw->ihw", Kinv, jnp.stack([xx, yy, ones]),
                          precision=_HI)
        dirs = jnp.einsum("ij,jhw->ihw", R, rays, precision=_HI)  # [3, H, W] world dirs
        # Per-plane ray parameter: lam_i = (d_i - n_i.t) / (n_i.dir).
        ndotdir = jnp.einsum("pi,ihw->phw", self.n, dirs, precision=_HI)
        ndott = jnp.matmul(self.n, t, precision=_HI)  # [P]
        lam = (self.d - ndott)[:, None, None] / jnp.where(
            jnp.abs(ndotdir) < 1e-6, 1e-6, ndotdir)
        lam = jnp.where(lam > 0.05, lam, jnp.inf)  # behind-camera cull
        best = jnp.argmin(lam, axis=0)  # [H, W] winning plane (z-buffer)
        lam_b = jnp.min(lam, axis=0)
        hit = jnp.isfinite(lam_b)
        lam_b = jnp.where(hit, lam_b, 0.0)
        p = t[:, None, None] + lam_b[None] * dirs  # [3, H, W] world point
        # Per-plane texture coords, then select the winning plane's sample.
        s = self.texture_scale
        c = self.tex_size / 2.0
        rel = p[None] - self.o[:, :, None, None]   # [P, 3, H, W]
        tx = jnp.einsum("pi,pihw->phw", self.u, rel, precision=_HI) * s + c
        ty = jnp.einsum("pi,pihw->phw", self.v, rel, precision=_HI) * s + c
        samp = jax.vmap(bilinear_sample)(self.tex, ty, tx)  # [P, H, W]
        one_hot = jax.nn.one_hot(best, self.n.shape[0], axis=0)
        img = jnp.sum(samp * one_hot, axis=0)
        img = jnp.where(hit, img, 128.0)
        depth = jnp.where(hit, lam_b * rays[2], 0.0)
        return img, depth

    def _add_noise(self, img: jnp.ndarray, frame_key) -> jnp.ndarray:
        if self.noise_std <= 0.0 or frame_key is None:
            return img
        noise = jax.random.normal(frame_key, img.shape) * self.noise_std
        return jnp.clip(img + noise, 0.0, 255.0)

    def render(self, Tcw: jnp.ndarray, frame: int = 0) -> jnp.ndarray:
        img, _ = self._render_depth(Tcw)
        key = (jax.random.PRNGKey(self._noise_seed * 977 + frame * 2)
               if self.noise_std > 0 else None)
        return self._add_noise(img, key)

    def render_stereo(self, Tcw: jnp.ndarray, frame: int = 0):
        b = self.cam.baseline
        T_rl = se3.from_Rt(jnp.eye(3), jnp.array([-b, 0.0, 0.0]))
        l, _ = self._render_depth(Tcw)
        r, _ = self._render_depth(se3.compose(T_rl, Tcw))
        if self.noise_std > 0:
            k = jax.random.PRNGKey(self._noise_seed * 977 + frame * 2)
            kl, kr = jax.random.split(k)
            l, r = self._add_noise(l, kl), self._add_noise(r, kr)
        return l, r

    def depth(self, Tcw: jnp.ndarray) -> jnp.ndarray:
        _, d = self._render_depth(Tcw)
        return d


class SceneWorld:
    """Photometrically richer 3-D validation world: finite textured
    rectangles with z-buffer OCCLUSION, Lambertian shading from a
    directional light, per-frame exposure drift, lens vignetting, and
    sensor noise — the closest this zero-egress container gets to the
    reference's dataset-driven validation imagery
    (ref: corbslam_client/Examples/Stereo/stereo_kitti.cc:96-116; VERDICT
    r4 missing #1). Unlike MultiPlaneWorld (infinite planes), objects here
    occlude each other and appear/disappear behind one another as the
    camera moves, perspective foreshortening varies per-patch, and the
    illumination of a surface changes with its orientation — stressing
    FAST/BRIEF/matching the way real photographs do, with exact GT depth.

    Rectangles: center o, in-plane axes u,v (unit), half-extents (eu, ev),
    outward normal n = u x v. A box contributes 6 rects; infinite planes
    use eu=ev=inf.
    """

    def __init__(self, cam: cam_mod.Intrinsics, rects, texture_size: int = 512,
                 texture_scale: float = 60.0, noise_std: float = 2.0,
                 light_dir=(0.4, -0.8, 0.45), ambient: float = 0.45,
                 diffuse: float = 0.55, exposure_amp: float = 0.12,
                 vignette: float = 0.22, seed: int = 0):
        """rects: list of (o [3], u [3], v [3], eu, ev)."""
        self.cam = cam
        self.texture_scale = float(texture_scale)
        self.tex_size = texture_size
        self.noise_std = float(noise_std)
        self.ambient = float(ambient)
        self.diffuse = float(diffuse)
        self.exposure_amp = float(exposure_amp)
        self.vignette = float(vignette)
        self._noise_seed = seed
        l = np.asarray(light_dir, np.float32)
        self.light = jnp.asarray(l / np.linalg.norm(l))
        o_l, u_l, v_l, n_l, e_l, tex = [], [], [], [], [], []
        for i, (o, u, v, eu, ev) in enumerate(rects):
            u = np.asarray(u, np.float32); u = u / np.linalg.norm(u)
            v = np.asarray(v, np.float32); v = v / np.linalg.norm(v)
            n = np.cross(u, v)
            o_l.append(np.asarray(o, np.float32)); u_l.append(u)
            v_l.append(v); n_l.append(n.astype(np.float32))
            e_l.append(np.asarray([eu, ev], np.float32))
            tex.append(random_texture(texture_size, texture_size,
                                      seed * 977 + 31 * i))
        self.o = jnp.asarray(np.stack(o_l))       # [P, 3]
        self.u = jnp.asarray(np.stack(u_l))
        self.v = jnp.asarray(np.stack(v_l))
        self.n = jnp.asarray(np.stack(n_l))
        self.e = jnp.asarray(np.stack(e_l))       # [P, 2] half extents
        self.tex = jnp.asarray(np.stack(tex))     # [P, S, S]

    @staticmethod
    def room_with_boxes(cam: cam_mod.Intrinsics, half: float = 14.0,
                        height: float = 3.0, n_boxes: int = 5,
                        box_ring: float = 8.0, seed: int = 0,
                        **kw) -> "SceneWorld":
        """A closed box room with free-standing textured boxes on the floor
        between the camera orbit and the walls — occluders for loop /
        tracking validation runs."""
        h, ht = half, height
        inf = 1e6
        rects = [
            ([0.0, 0.0, h],  [1, 0, 0], [0, 1, 0], inf, inf),   # front z=+h
            ([0.0, 0.0, -h], [-1, 0, 0], [0, 1, 0], inf, inf),  # back
            ([-h, 0.0, 0.0], [0, 0, 1], [0, 1, 0], inf, inf),   # left
            ([h, 0.0, 0.0],  [0, 0, -1], [0, 1, 0], inf, inf),  # right
            ([0.0, ht, 0.0], [1, 0, 0], [0, 0, 1], inf, inf),   # floor
            ([0.0, -ht, 0.0], [1, 0, 0], [0, 0, -1], inf, inf), # ceiling
        ]
        rng = np.random.default_rng(seed + 7)
        for b in range(n_boxes):
            th = 2 * np.pi * b / n_boxes + rng.uniform(-0.2, 0.2)
            r = box_ring + rng.uniform(-1.0, 1.5)
            cx, cz = r * np.sin(th), r * np.cos(th)
            sx, sy, sz = rng.uniform(0.8, 1.8, 3)
            cy = ht - sy  # resting on the floor (y up toward +ht)
            c, s = np.cos(th), np.sin(th)
            ax = np.array([c, 0, -s], np.float32)   # box local x
            az = np.array([s, 0, c], np.float32)    # box local z
            ay = np.array([0.0, 1.0, 0.0], np.float32)
            ctr = np.array([cx, cy, cz], np.float32)
            rects += [
                (ctr + az * sz, ax, ay, sx, sy), (ctr - az * sz, -ax, ay, sx, sy),
                (ctr + ax * sx, -az, ay, sz, sy), (ctr - ax * sx, az, ay, sz, sy),
                (ctr - ay * sy, ax, az, sx, sz), (ctr + ay * sy, ax, -az, sx, sz),
            ]
        return SceneWorld(cam, rects, seed=seed, **kw)

    def _render_depth(self, Tcw: jnp.ndarray):
        cam = self.cam
        Twc = se3.inverse(Tcw)
        R = se3.rotation(Twc)
        t = se3.translation(Twc)
        Kinv = jnp.linalg.inv(cam.K)
        h, w = cam.height, cam.width
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        ones = jnp.ones_like(xx)
        rays = jnp.einsum("ij,jhw->ihw", Kinv, jnp.stack([xx, yy, ones]),
                          precision=_HI)
        dirs = jnp.einsum("ij,jhw->ihw", R, rays, precision=_HI)  # [3, H, W]
        ndotdir = jnp.einsum("pi,ihw->phw", self.n, dirs, precision=_HI)
        ndoto = jnp.einsum("pi,pi->p", self.n, self.o, precision=_HI)
        ndott = jnp.matmul(self.n, t, precision=_HI)
        lam = (ndoto - ndott)[:, None, None] / jnp.where(
            jnp.abs(ndotdir) < 1e-6, 1e-6, ndotdir)         # [P, H, W]
        p = t[None, :, None, None] + lam[:, None] * dirs[None]  # [P,3,H,W]
        rel = p - self.o[:, :, None, None]
        cu = jnp.einsum("pi,pihw->phw", self.u, rel, precision=_HI)
        cv = jnp.einsum("pi,pihw->phw", self.v, rel, precision=_HI)
        in_rect = (jnp.abs(cu) <= self.e[:, 0, None, None]) & (
            jnp.abs(cv) <= self.e[:, 1, None, None])
        lam = jnp.where((lam > 0.05) & in_rect, lam, jnp.inf)
        best = jnp.argmin(lam, axis=0)
        lam_b = jnp.min(lam, axis=0)
        hit = jnp.isfinite(lam_b)
        lam_b = jnp.where(hit, lam_b, 0.0)
        s = self.texture_scale
        c = self.tex_size / 2.0
        samp = jax.vmap(bilinear_sample)(self.tex, cv * s + c, cu * s + c)
        # Lambertian shading per rect (two-sided).
        shade = self.ambient + self.diffuse * jnp.abs(jnp.matmul(self.n, self.light, precision=_HI))
        samp = samp * shade[:, None, None]
        one_hot = jax.nn.one_hot(best, self.n.shape[0], axis=0)
        img = jnp.sum(samp * one_hot, axis=0)
        img = jnp.where(hit, img, 96.0)
        depth = jnp.where(hit, lam_b * rays[2], 0.0)
        return img, depth

    def _photometric(self, img: jnp.ndarray, frame, key) -> jnp.ndarray:
        # Exposure drift (slow sinusoid over frames) + radial vignette +
        # gaussian sensor noise. `frame` may be a traced scalar (the
        # endurance bench jits the whole render with the frame id as an
        # argument).
        h, w = img.shape
        f = jnp.asarray(frame, jnp.float32)
        gain = 1.0 + self.exposure_amp * jnp.sin(0.07 * f + 0.9)
        bias = 6.0 * jnp.sin(0.045 * f)
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) / h - 0.5
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) / w - 0.5
        vig = 1.0 - self.vignette * 2.0 * (xx * xx + yy * yy)
        img = img * gain * vig + bias
        if self.noise_std > 0 and key is not None:
            img = img + jax.random.normal(key, img.shape) * self.noise_std
        return jnp.clip(img, 0.0, 255.0)

    def render(self, Tcw: jnp.ndarray, frame: int = 0) -> jnp.ndarray:
        img, _ = self._render_depth(Tcw)
        k = jax.random.PRNGKey(self._noise_seed * 977 + frame * 2)
        return self._photometric(img, frame, k)

    def render_stereo(self, Tcw: jnp.ndarray, frame: int = 0):
        b = self.cam.baseline
        T_rl = se3.from_Rt(jnp.eye(3), jnp.array([-b, 0.0, 0.0]))
        l, _ = self._render_depth(Tcw)
        r, _ = self._render_depth(se3.compose(T_rl, Tcw))
        k = jax.random.PRNGKey(self._noise_seed * 977 + frame * 2)
        kl, kr = jax.random.split(k)
        return self._photometric(l, frame, kl), self._photometric(r, frame, kr)

    def depth(self, Tcw: jnp.ndarray) -> jnp.ndarray:
        _, d = self._render_depth(Tcw)
        return d
