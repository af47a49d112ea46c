"""Tests for the ORB front-end kernels (pyramid, FAST, BRIEF, full extract).

The reference validates these only visually/end-to-end (SURVEY.md §4); here
each kernel gets a synthetic-ground-truth check, plus view-invariance checks
matching become the parity criterion (SURVEY.md §7.2 step 2: "match counts
within tolerance", not bit-exactness).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from corbslam.config import OrbConfig
from corbslam.io import synthetic
from corbslam.ops import brief, descriptors, fast, orb, pyramid


class TestPyramid:
    def test_level_shapes(self):
        shapes = pyramid.level_shapes(376, 1241, 8, 1.2)
        assert shapes[0] == (376, 1241)
        assert shapes[1] == (313, 1034)
        assert all(s[0] >= 16 for s in shapes)

    def test_blur_preserves_mean(self, rng):
        img = jnp.asarray(rng.uniform(0, 255, (64, 96)).astype(np.float32))
        out = pyramid.gaussian_blur(img)
        assert abs(float(out.mean()) - float(img.mean())) < 2.0
        # Blur reduces variance
        assert float(out.var()) < float(img.var())


class TestFast:
    def test_detects_planted_corners(self):
        # Dark image with bright squares: their corners are FAST corners.
        img = np.zeros((128, 128), np.float32)
        corners = [(32, 32), (32, 96), (96, 32), (96, 96)]
        for (cy, cx) in corners:
            img[cy : cy + 20, cx : cx + 20] = 200.0
        score = np.asarray(fast.fast_score_map(jnp.asarray(img), 20.0))
        # Each square corner pixel region should contain positive scores.
        for (cy, cx) in corners:
            assert score[cy - 2 : cy + 3, cx - 2 : cx + 3].max() > 0, (cy, cx)
        # Flat regions have zero score.
        assert score[60:70, 60:70].max() == 0.0

    def test_no_corners_on_flat(self):
        img = jnp.full((64, 64), 100.0)
        score = np.asarray(fast.fast_score_map(img, 7.0))
        assert score.max() == 0.0

    def test_grid_selection_spreads(self):
        img = jnp.asarray(synthetic.random_texture(128, 128, seed=1))
        score = fast.nms3x3(fast.fast_score_map(img, 7.0))
        xy, resp, valid = fast.select_keypoints_grid(score, cell=16, max_kp=64)
        xy, valid = np.asarray(xy), np.asarray(valid)
        assert valid.sum() > 20
        # At most one keypoint per 16x16 cell
        cells = set()
        for (x, y) in xy[valid]:
            c = (int(y) // 16, int(x) // 16)
            assert c not in cells
            cells.add(c)


class TestBrief:
    def test_orientation_rotates_with_image(self):
        # A gradient patch rotated 90 deg should rotate the angle by ~90 deg.
        img = np.tile(np.linspace(0, 255, 64, dtype=np.float32), (64, 1))
        xy = jnp.asarray([[32.0, 32.0]])
        a0 = float(brief.compute_orientation(jnp.asarray(img), xy)[0])
        a90 = float(brief.compute_orientation(jnp.asarray(np.rot90(img).copy()), xy)[0])
        diff = (a90 - a0) % (2 * np.pi)
        assert min(abs(diff - np.pi / 2), abs(diff - 3 * np.pi / 2)) < 0.1

    def test_descriptor_stability_under_shift(self):
        # Descriptors at the same physical point in a shifted image match.
        tex = synthetic.random_texture(256, 256, seed=2)
        img1 = jnp.asarray(tex[:192, :192])
        img2 = jnp.asarray(tex[8:200, 4:196])  # shift by (8, 4)
        pts1 = jnp.asarray(np.random.default_rng(0).uniform(40, 150, (32, 2)).astype(np.float32))
        pts2 = pts1 - jnp.asarray([4.0, 8.0])  # (x, y) offsets
        b1 = pyramid.gaussian_blur(img1)
        b2 = pyramid.gaussian_blur(img2)
        a1 = brief.compute_orientation(img1, pts1)
        a2 = brief.compute_orientation(img2, pts2)
        d1 = brief.compute_brief(b1, pts1, a1)
        d2 = brief.compute_brief(b2, pts2, a2)
        dist = np.asarray(descriptors.hamming_pairwise(d1, d2))
        assert np.median(dist) < 40  # same points: small Hamming distance
        # vs random pairing: large distance
        d_rand = np.asarray(descriptors.hamming_pairwise(d1, jnp.roll(d2, 1, axis=0)))
        assert np.median(d_rand) > 80


class TestFullExtract:
    @pytest.fixture(scope="class")
    def feats(self):
        cfg = OrbConfig(n_features=512, n_levels=4, cell_size=16)
        img = jnp.asarray(synthetic.random_texture(240, 320, seed=3))
        return orb.extract(img, cfg), cfg

    def test_shapes_and_validity(self, feats):
        f, cfg = feats
        assert f.xy.shape == (512, 2)
        assert f.desc.shape == (512, 32)
        assert np.asarray(f.valid).sum() > 256  # textured image: most slots fill

    def test_coords_in_bounds(self, feats):
        f, _ = feats
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 320).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 240).all()

    def test_octaves_populated(self, feats):
        f, cfg = feats
        oct_ = np.asarray(f.octave)[np.asarray(f.valid)]
        assert set(np.unique(oct_)) == set(range(cfg.n_levels))

    def test_two_view_matching(self):
        """The end-goal property: two shifted views of one texture produce
        many correct mutual matches via the Hamming matcher."""
        cfg = OrbConfig(n_features=512, n_levels=4, cell_size=16)
        tex = synthetic.random_texture(320, 400, seed=4)
        img1 = jnp.asarray(tex[:256, :320])
        img2 = jnp.asarray(tex[10:266, 6:326])  # shift (dy=10, dx=6)
        f1 = orb.extract(img1, cfg)
        f2 = orb.extract(img2, cfg)
        d = descriptors.masked_hamming_matrix(
            f1.desc, f2.desc, valid_a=f1.valid, valid_b=f2.valid
        )
        idx, dist, ok = descriptors.mutual_best(d, max_dist=50, ratio=0.8)
        idx, ok = np.asarray(idx), np.asarray(ok)
        assert ok.sum() > 50
        # Matched keypoints should differ by ~(dx=-6, dy=-10) in image coords
        xy1 = np.asarray(f1.xy)[ok]
        xy2 = np.asarray(f2.xy)[idx[ok]]
        delta = xy1 - xy2
        med = np.median(delta, axis=0)
        np.testing.assert_allclose(med, [6.0, 10.0], atol=1.5)
        # Most matches agree with the global shift (inlier ratio)
        inliers = (np.abs(delta - [6, 10]) < 2).all(axis=1)
        assert inliers.mean() > 0.7


def _np_bilinear(img, out_hw):
    """Half-pixel bilinear resize, one output pixel at a time (float64)."""
    h_in, w_in = img.shape
    h, w = out_hw
    out = np.zeros((h, w))
    for i in range(h):
        y = min(max((i + 0.5) * h_in / h - 0.5, 0.0), h_in - 1)
        y0 = int(np.floor(y)); y1 = min(y0 + 1, h_in - 1); fy = y - y0
        for j in range(w):
            x = min(max((j + 0.5) * w_in / w - 0.5, 0.0), w_in - 1)
            x0 = int(np.floor(x)); x1 = min(x0 + 1, w_in - 1); fx = x - x0
            top = (1 - fx) * img[y0, x0] + fx * img[y0, x1]
            bot = (1 - fx) * img[y1, x0] + fx * img[y1, x1]
            out[i, j] = (1 - fy) * top + fy * bot
    return out


@pytest.mark.parametrize("in_hw,out_hw", [((48, 70), (40, 58)), ((31, 45), (26, 37))])
def test_resize_bilinear_matches_numpy(in_hw, out_hw):
    img = np.random.default_rng(1).uniform(0, 255, in_hw).astype(np.float32)
    got = np.asarray(pyramid.resize_bilinear(jnp.asarray(img), out_hw))
    np.testing.assert_allclose(got, _np_bilinear(img.astype(np.float64), out_hw),
                               atol=1e-3)


def _keypoints(levels, n, seed):
    """n random in-bounds (octave, y, x) keypoints over the given levels."""
    rng = np.random.default_rng(seed)
    octv = rng.integers(0, len(levels), n)
    yx = np.stack([
        [rng.integers(0, levels[o].shape[0]), rng.integers(0, levels[o].shape[1])]
        for o in octv])
    return octv.astype(np.int32), yx.astype(np.int32)


def test_patches_match_numpy_slicing():
    from corbslam.ops import patches

    rng = np.random.default_rng(2)
    levels = [rng.uniform(0, 255, hw).astype(np.float32)
              for hw in [(60, 90), (50, 75), (42, 63)]]
    octv, yx = _keypoints(levels, 40, 3)
    fl = patches.flatten_levels([jnp.asarray(l) for l in levels])
    base, stride = patches.keypoint_index(fl, jnp.asarray(octv), jnp.asarray(yx))
    got = np.asarray(patches.gather_patches(fl, base, stride, 32))
    P = patches.PAD
    for k in range(len(octv)):
        pad = np.pad(levels[octv[k]], P)
        y, x = yx[k] + P
        np.testing.assert_array_equal(got[k], pad[y - 16:y + 16, x - 16:x + 16])


def _np_brief_selection(patch, n_bins):
    """[patch*patch, n_bins*512] one-hot steered-BRIEF selection matrix:
    column (b*512 + 2*i + e) selects pattern pair i, endpoint e, rotated by
    2*pi*b/n_bins, rounded and clipped to the patch interior."""
    c = patch // 2
    pat = brief.BRIEF_PATTERN.astype(np.float32)
    py, px = pat[..., 0], pat[..., 1]
    sel = np.zeros((patch * patch, n_bins * 512))
    lim = patch // 2 - 1
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        cth, sth = np.cos(th), np.sin(th)
        rx = np.clip(np.round(px * cth - py * sth), -lim, lim).astype(np.int64)
        ry = np.clip(np.round(px * sth + py * cth), -lim, lim).astype(np.int64)
        lin = (c + ry) * patch + (c + rx)
        cols = b * 512 + np.arange(256)[:, None] * 2 + np.arange(2)[None, :]
        sel[lin.reshape(-1), cols.reshape(-1)] = 1.0
    return sel


def test_brief_gather_matches_selection_reference():
    """The table gather reproduces the full-precision selection matmul bit
    for bit, so descriptors (and the vocabulary trained on them) keep their
    meaning."""
    from corbslam.ops import patches

    rng = np.random.default_rng(4)
    levels = [pyramid.gaussian_blur(jnp.asarray(
        synthetic.random_texture(hw[0], hw[1], seed=i))) for i, hw in
        enumerate([(80, 120), (66, 100)])]
    octv, yx = _keypoints(levels, 64, 5)
    angle = rng.uniform(-np.pi, np.pi, len(octv)).astype(np.float32)
    fl = patches.flatten_levels(levels)
    base, stride = patches.keypoint_index(fl, jnp.asarray(octv), jnp.asarray(yx))
    got = np.asarray(brief.brief_from_levels(fl, base, stride, jnp.asarray(angle)))

    P, B = 2 * (brief.BRIEF_LIM + 1), brief.N_ANGLE_BINS
    sel = _np_brief_selection(P, B)
    bins = np.asarray(brief.angle_bin(jnp.asarray(angle)))
    for k in range(len(octv)):
        pad = np.pad(np.asarray(levels[octv[k]], np.float64), patches.PAD)
        y, x = yx[k] + patches.PAD
        patch = pad[y - P // 2:y + P // 2, x - P // 2:x + P // 2].reshape(-1)
        samp = (patch @ sel).reshape(B, 256, 2)[bins[k]]
        bits = (samp[:, 0] < samp[:, 1]).astype(np.uint8)
        want = np.packbits(bits, bitorder="little")
        np.testing.assert_array_equal(got[k], want)
