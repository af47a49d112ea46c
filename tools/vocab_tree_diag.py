"""Diagnose the artifact vocabulary's held-out recall shortfall.

Hypotheses (VERDICT r4 #5: artifact must reach held-out recall@1 >= 0.9):
  (a) the 2-level descent tree's greedy single-group descent assigns
      descriptors to the wrong word often enough to cost recall — measured
      as flat-vs-tree assignment agreement and recall with the tree
      stripped;
  (b) the training corpus still mismatches the eval world's descriptor
      statistics — measured as recall with exact (flat) assignment.

Run: python -u tools/vocab_tree_diag.py   (CPU, ~2 min)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from corbslam import compile_cache

    compile_cache.configure()
    import jax.numpy as jnp

    from corbslam.config import OrbConfig, SlamConfig
    from corbslam.frontend import frame as frame_mod
    from corbslam.geometry import camera, se3
    from corbslam.io import synthetic
    from corbslam.ops import descriptors as D
    from corbslam.place import vocab as vocab_mod

    cam = camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
        width=320, height=240,
    )
    cfg = SlamConfig(orb=OrbConfig(n_features=512, n_levels=4, cell_size=12))
    world = synthetic.MultiPlaneWorld.room(
        cam, half=14.0, height=3.0, noise_std=3.0, seed=2)

    n = 36
    step = 2 * np.pi / n

    def pose(th, radius=5.0):
        Twc = se3.compose(
            se3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
            se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -radius])),
        )
        return se3.inverse(Twc)

    db_desc, db_valid, db_th = [], [], []
    h_desc, h_valid, h_th = [], [], []
    for i in range(n):
        th = step * i
        img, _ = world.render_stereo(pose(th), frame=i)
        f = frame_mod.build_frame_mono(img, cam, cfg.orb)
        db_desc.append(np.asarray(f.desc))
        db_valid.append(np.asarray(f.fvalid))
        db_th.append(th)
        th_q = th + 0.5 * step
        img3, _ = world.render_stereo(pose(th_q, radius=7.5), frame=2000 + i)
        f3 = frame_mod.build_frame_mono(img3, cam, cfg.orb)
        h_desc.append(np.asarray(f3.desc))
        h_valid.append(np.asarray(f3.fvalid))
        h_th.append(th_q)

    voc = vocab_mod.load_default()
    assert voc is not None
    voc_flat = voc._replace(group_bits=None, child_idx=None)
    import time as _t

    t0 = _t.time()
    voc_re = vocab_mod.build_tree(voc_flat, n_groups=1024, dup=4)
    print(f"rebuilt duplicated tree in {_t.time()-t0:.1f}s")

    # (a) assignment agreement on held-out descriptors, per descent width
    bits = D.unpack_bits(jnp.asarray(h_desc[0]))
    a_flat = np.asarray(vocab_mod._assign(bits, voc.word_bits))
    hv = np.asarray(h_valid[0])
    for tg in (1, 2, 4):
        a_old = np.asarray(vocab_mod._assign_tree(bits, voc, top_g=tg))
        a_new = np.asarray(vocab_mod._assign_tree(bits, voc_re, top_g=tg))
        print(f"top_g={tg:2d}: agreement old-tree "
              f"{float((a_flat == a_old)[hv].mean()):.3f}  dup-tree "
              f"{float((a_flat == a_new)[hv].mean()):.3f}")
    voc = voc_re

    tol = np.deg2rad(12.0)

    def ang_dist(a, b):
        d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :]) % (2 * np.pi)
        return np.minimum(d, 2 * np.pi - d)

    gt = ang_dist(h_th, db_th) <= tol

    def recall(v):
        db_bow = vocab_mod.transform_many(
            v, jnp.asarray(np.stack(db_desc)), jnp.asarray(np.stack(db_valid)))
        q_bow = vocab_mod.transform_many(
            v, jnp.asarray(np.stack(h_desc)), jnp.asarray(np.stack(h_valid)))
        scores = np.stack([
            np.asarray(vocab_mod.l1_scores(q_bow[i], db_bow))
            for i in range(n)
        ])
        order = np.argsort(-scores, axis=1)
        r1 = gt[np.arange(n)[:, None], order[:, :1]].any(1).mean()
        r5 = gt[np.arange(n)[:, None], order[:, :5]].any(1).mean()
        return float(r1), float(r5)

    r1_t, r5_t = recall(voc)
    r1_f, r5_f = recall(voc_flat)
    out = {
        "tree_flat_agreement": round(agree, 4),
        "recall1_tree": round(r1_t, 4), "recall5_tree": round(r5_t, 4),
        "recall1_flat": round(r1_f, 4), "recall5_flat": round(r5_f, 4),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
