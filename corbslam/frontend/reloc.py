"""Relocalization: recover a LOST frame's pose from the keyframe database.

Replaces `Tracking::Relocalization` (ref: corbslam_client/src/
Tracking.cc:1368: DetectRelocalizationCandidates -> per-candidate
SearchByBoW >= 15 matches -> PnPsolver RANSAC -> PoseOptimization >= 50
inliers, with a projection-widening retry). Re-design: the BoW query
is one dense score+top-k (place/database.py); per-candidate verification is
one fused program (dense descriptor matching + batched PnP RANSAC + LM
pose refinement); the host only walks the tiny candidate list.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import pose_opt
from ..solvers import pnp as pnp_mod


class RelocResult(NamedTuple):
    Tcw: jnp.ndarray
    mp_idx: jnp.ndarray   # [F] map-point rows for the frame's features
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


@partial(jax.jit, static_argnames=("cam", "cfg"))
def try_relocalize_against(
    cam: cam_mod.Intrinsics,
    m: ms.MapState,
    cand_row,
    frame,                 # frontend.frame.FrameData
    key: jnp.ndarray,
    cfg: SlamConfig,
) -> RelocResult:
    """Verify one relocalization candidate keyframe: match the frame's
    features against the candidate's bound landmarks, PnP RANSAC, then
    motion-only LM with outlier re-classification."""
    mp_c = m.kf.mp_idx[cand_row]
    bound_c = m.kf.fvalid[cand_row] & (mp_c >= 0)
    res = matcher.search_by_descriptor(
        frame.desc, frame.fvalid, m.kf.desc[cand_row], bound_c,
        max_dist=cfg.matcher.th_low, ratio=0.75,
    )
    hit = res.idx >= 0
    rows = jnp.where(hit, mp_c[jnp.clip(res.idx, 0)], ms.NO_MP)
    hit &= rows >= 0
    X = m.mp.pos[jnp.clip(rows, 0)]
    sf2 = cfg.orb.scale_factor ** 2
    sigma2 = sf2 ** frame.octave.astype(jnp.float32)

    pnp = pnp_mod.solve_pnp_ransac(
        cam, X, frame.xy, hit, sigma2, key,
        n_hyp=256, min_inliers=cfg.tracking.min_matches_reloc,
    )

    # Motion-only refinement over the PnP consensus (PoseOptimization,
    # Tracking.cc:1446).
    uvr = jnp.concatenate([frame.xy, frame.uright[:, None]], axis=-1)
    opt = pose_opt.optimize_pose(
        cam, pnp.Tcw, X, uvr, 1.0 / sigma2,
        frame.uright > 0, pnp.inliers,
    )
    mp_idx = jnp.where(opt.inliers, rows, ms.NO_MP)
    n = jnp.sum(opt.inliers)
    ok = pnp.ok & (n >= 30)  # the reference demands 50; our budget is smaller
    return RelocResult(opt.Tcw, mp_idx, n, ok)


def relocalize(cam, m: ms.MapState, db, voc, frame, key, cfg: SlamConfig,
               k: int = 5):
    """Full relocalization: BoW candidates + per-candidate verification.
    Host walks the candidate list (tiny); returns RelocResult or None."""
    import numpy as np

    from ..place import database as db_mod
    from ..place import vocab as vocab_mod

    bow = vocab_mod.transform(voc, frame.desc, frame.fvalid)
    rows, ok = db_mod.detect_relocalization_candidates(db, m, bow, k=k)
    for r, o in zip(np.asarray(rows), np.asarray(ok)):
        if not o:
            continue
        key, sub = jax.random.split(key)
        res = try_relocalize_against(cam, m, int(r), frame, sub, cfg)
        if bool(res.ok):
            return res
    return None
