"""New-landmark creation by inter-keyframe triangulation.

Replaces `LocalMapping::CreateNewMapPoints` (ref:
corbslam_client/src/LocalMapping.cc:190): for each strong covisible
neighbor of the new keyframe, epipolar-constrained matching of UNBOUND
features (matching/matcher.py search_for_triangulation) followed by
two-view triangulation and the reference's acceptance gates (parallax,
cheirality in both views, reprojection chi2, scale-consistency band,
LocalMapping.cc:246-380).

Re-design: ALL neighbors are processed in one vmapped program —
[K, F] candidate landmarks with masks — then one per-feature argmin picks
the best hypothesis per new-keyframe feature and one masked batch
insertion allocates the landmarks. Rays are intersected with the midpoint
method (two-view closed form, pure arithmetic) instead of the reference's
per-pair 4x4 SVD (LocalMapping.cc:302) — an SVD per candidate is
costly in batch; the reprojection gate rejects the cases where the methods
differ (near-degenerate geometry).

This is essential for the monocular pipeline (stereo/RGB-D can spawn
landmarks from per-frame depth, Tracking.cc:1113; mono cannot) and
deepens stereo maps beyond the depth range.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher

_HI = jax.lax.Precision.HIGHEST

NO_MP = ms.NO_MP


def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoint of the closest segment between rays o+t*d (unit d not
    required). Returns (X [..., 3], s1, s2) with s_i the ray parameters."""
    r = o2 - o1
    a = jnp.sum(d1 * d1, -1)
    b = jnp.sum(d1 * d2, -1)
    c = jnp.sum(d2 * d2, -1)
    e = jnp.sum(d1 * r, -1)
    f = jnp.sum(d2 * r, -1)
    den = a * c - b * b
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    s1 = (c * e - b * f) / den
    s2 = (b * e - a * f) / den
    p1 = o1 + s1[..., None] * d1
    p2 = o2 + s2[..., None] * d2
    return 0.5 * (p1 + p2), s1, s2


@partial(jax.jit, static_argnames=("cam", "cfg", "n_neighbors"))
def create_new_points(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    kf_row,
    cfg: SlamConfig,
    n_neighbors: int = 8,
):
    """Triangulate new landmarks between keyframe `kf_row` and its top
    covisible neighbors; returns the updated map."""
    F = m.kf.n_features
    scales = jnp.asarray(cfg.orb.scales(), jnp.float32)
    sigma2 = scales ** 2

    nb_rows, nb_ok = covis.top_covisible_of(
        m, kf_row, n_neighbors, min_weight=15)  # GetBestCovisibility threshold

    T1 = m.kf.Tcw[kf_row]
    xy1 = m.kf.xy[kf_row]
    oct1 = m.kf.octave[kf_row]
    desc1 = m.kf.desc[kf_row]
    unbound1 = m.kf.fvalid[kf_row] & (m.kf.mp_idx[kf_row] < 0)
    o1 = -jnp.matmul(T1[:3, :3].T, T1[:3, 3], precision=_HI)

    # Median scene depth of the new keyframe (baseline significance gate,
    # LocalMapping.cc:236: ratioBaselineDepth > 0.01 for mono).
    own_pts = covis.point_mask_of_kf(m, kf_row)
    z = se3.transform(T1, m.mp.pos)[:, 2]
    z_masked = jnp.where(own_pts, z, jnp.nan)
    median_depth = jnp.nanmedian(z_masked)
    median_depth = jnp.where(jnp.isfinite(median_depth), median_depth, 1.0)

    def per_neighbor(nb, ok_nb):
        T2 = m.kf.Tcw[nb]
        o2 = -jnp.matmul(T2[:3, :3].T, T2[:3, 3], precision=_HI)
        baseline = jnp.linalg.norm(o2 - o1)
        base_ok = baseline / jnp.maximum(median_depth, 1e-6) > 0.01
        unbound2 = m.kf.fvalid[nb] & (m.kf.mp_idx[nb] < 0)
        F12 = matcher.fundamental_from_poses(cam, T1, cam, T2)
        # Epipole of cam1 in image 2 (parallax guard).
        e2 = cam_mod.project(cam, se3.transform(T2, o1[None]))[0]
        res = matcher.search_for_triangulation(
            desc1, xy1, unbound1, ~unbound1 & m.kf.fvalid[kf_row],
            m.kf.desc[nb], m.kf.xy[nb], m.kf.octave[nb], unbound2,
            ~unbound2 & m.kf.fvalid[nb],
            F12, sigma2,
            epi_center2=e2,
            min_epi_dist=jnp.sqrt(100.0 * scales[m.kf.octave[nb]]),
            max_dist=cfg.matcher.th_low,
        )
        f2 = jnp.clip(res.idx, 0)
        has = res.idx >= 0
        # Rays in world coords.
        xy2 = m.kf.xy[nb][f2]
        d1 = cam_mod.backproject(cam, xy1, jnp.ones(F))  # unit-depth cam dirs
        d1w = jnp.einsum("ji,fj->fi", T1[:3, :3], d1, precision=_HI)  # R1^T d
        d2 = cam_mod.backproject(cam, xy2, jnp.ones(F))
        d2w = jnp.einsum("ji,fj->fi", T2[:3, :3], d2, precision=_HI)
        X, s1, s2 = triangulate_midpoint(
            jnp.broadcast_to(o1, (F, 3)), d1w, jnp.broadcast_to(o2, (F, 3)), d2w
        )
        # Gates (LocalMapping.cc:316-379):
        p1c = se3.transform(T1, X)
        p2c = se3.transform(T2, X)
        cheir = (p1c[:, 2] > 0) & (p2c[:, 2] > 0)
        # Parallax: angle between rays > ~1.1 deg (cosParallax < 0.9998).
        cospar = jnp.sum(d1w * d2w, -1) / jnp.maximum(
            jnp.linalg.norm(d1w, axis=-1) * jnp.linalg.norm(d2w, axis=-1), 1e-9
        )
        par_ok = cospar < 0.9998
        uv1 = cam_mod.project(cam, p1c)
        uv2 = cam_mod.project(cam, p2c)
        e1 = jnp.sum((uv1 - xy1) ** 2, -1)
        e2r = jnp.sum((uv2 - xy2) ** 2, -1)
        chi_ok = (e1 < 5.991 * sigma2[oct1]) & (
            e2r < 5.991 * sigma2[m.kf.octave[nb][f2]]
        )
        # Scale consistency: distance ratio within the pyramid band.
        dist1 = jnp.linalg.norm(X - o1, axis=-1)
        dist2 = jnp.linalg.norm(X - o2, axis=-1)
        ratio_d = dist1 / jnp.maximum(dist2, 1e-9)
        ratio_o = scales[m.kf.octave[nb][f2]] / scales[oct1]
        sc_ok = (ratio_d < ratio_o * 1.5 * cfg.orb.scale_factor) & (
            ratio_d * 1.5 * cfg.orb.scale_factor > ratio_o
        )
        ok = has & cheir & par_ok & chi_ok & sc_ok & base_ok & ok_nb
        err = jnp.where(ok, e1 + e2r, jnp.inf)
        return X, ok, f2, err, dist1

    X_all, ok_all, f2_all, err_all, dist_all = jax.vmap(per_neighbor)(
        nb_rows, nb_ok
    )  # [K, F, ...]

    # Per new-KF feature: best neighbor hypothesis by reprojection error.
    best_nb = jnp.argmin(err_all, axis=0)                # [F]
    fidx = jnp.arange(F)
    create = jnp.isfinite(err_all[best_nb, fidx])        # [F]
    X = X_all[best_nb, fidx]
    f2 = f2_all[best_nb, fidx]
    nb_of_f = nb_rows[best_nb]
    dist1 = dist_all[best_nb, fidx]

    # Scale band + normal from the new keyframe's viewpoint
    # (MapPoint ctor semantics, as in insert_keyframe_with_points).
    level_scale = scales[oct1]
    max_dist = dist1 * level_scale
    min_dist = max_dist / (cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))
    normal = X - o1
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9
    )

    m2, rows = ms.add_map_points(
        m, X, desc1, normal, min_dist, max_dist,
        ref_kf=kf_row, create=create, client=m.kf.client[kf_row],
    )
    # Bind both observations (AddObservation on both keyframes,
    # LocalMapping.cc:362-365).
    new_idx1 = jnp.where(create, rows, m2.kf.mp_idx[kf_row])
    kf = m2.kf._replace(mp_idx=m2.kf.mp_idx.at[kf_row].set(new_idx1))
    # Neighbor-side scatter: (nb_of_f, f2) <- rows where created. Multiple
    # features could collide on the same neighbor slot; .at[].max with
    # row ids keeps one deterministically (unbound slots hold NO_MP = -1).
    safe_nb = jnp.where(create, nb_of_f, kf_row)
    safe_f2 = jnp.where(create, f2, 0)
    cur = kf.mp_idx[safe_nb, safe_f2]
    val = jnp.where(create & (cur < 0), rows, cur)
    kf = kf._replace(mp_idx=kf.mp_idx.at[safe_nb, safe_f2].max(val))
    return m2._replace(kf=kf)
