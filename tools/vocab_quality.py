"""Vocabulary quality at scale: loop-detection retrieval precision/recall on
a synthetic revisit sequence, across vocabulary sizes.

The reference rides on a k=10/L=6 DBoW2 tree (~1M leaf words,
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h); our flat vocabulary defaults
to 4096 words. This measures what that choice costs: two laps around the
room world, lap-1 keyframes form the database, lap-2 frames query it, and a
query is CORRECT when a retrieved keyframe is within an angular window of
the query's orbit angle (ground truth from the generator).

Run: python -u tools/vocab_quality.py [--cpu]
Prints one JSON line per vocabulary size + writes VOCAB_QUALITY.json.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-per-lap", type=int, default=72)
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[1024, 4096, 32768])
    ap.add_argument("--artifacts", nargs="*", default=[],
                    help="extra vocabulary npz files to evaluate by path")
    ap.add_argument("--tol-deg", type=float, default=12.0)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from corbslam import compile_cache

    compile_cache.configure()
    import jax.numpy as jnp

    from corbslam.config import CapacityConfig, OrbConfig, SlamConfig
    from corbslam.frontend import frame as frame_mod
    from corbslam.geometry import camera, se3
    from corbslam.io import synthetic
    from corbslam.place import vocab as vocab_mod

    cam = camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
        width=320, height=240,
    )
    cfg = SlamConfig(orb=OrbConfig(n_features=512, n_levels=4, cell_size=12))
    world = synthetic.MultiPlaneWorld.room(
        cam, half=14.0, height=3.0, noise_std=3.0, seed=2)

    n = args.n_per_lap
    step = 2 * np.pi / n

    def pose(th, radius=5.0):
        Twc = se3.compose(
            se3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
            se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -radius])),
        )
        return se3.inverse(Twc)

    # Lap 1 = database; lap 2 = queries at half-step offset angles with
    # fresh photometric noise (a genuine revisit, not the same image).
    # Lap 3 = the HARD held-out queries: a different orbit radius on top of
    # the angular offset (viewpoint + scale change), where recall@1 < 1.0
    # so vocabulary sizes/methods are discriminable (VERDICT r3 weak #8 —
    # the easy set saturates at 1.0 for every size).
    print(f"rendering 3x{n} frames ...", flush=True)
    db_desc, db_valid, db_th = [], [], []
    q_desc, q_valid, q_th = [], [], []
    h_desc, h_valid, h_th = [], [], []
    for i in range(n):
        th = step * i
        img, _ = world.render_stereo(pose(th), frame=i)
        f = frame_mod.build_frame_mono(img, cam, cfg.orb)
        db_desc.append(np.asarray(f.desc))
        db_valid.append(np.asarray(f.fvalid))
        db_th.append(th)
        th_q = th + 0.5 * step
        img2, _ = world.render_stereo(pose(th_q), frame=1000 + i)
        f2 = frame_mod.build_frame_mono(img2, cam, cfg.orb)
        q_desc.append(np.asarray(f2.desc))
        q_valid.append(np.asarray(f2.fvalid))
        q_th.append(th_q)
        img3, _ = world.render_stereo(pose(th_q, radius=7.5), frame=2000 + i)
        f3 = frame_mod.build_frame_mono(img3, cam, cfg.orb)
        h_desc.append(np.asarray(f3.desc))
        h_valid.append(np.asarray(f3.fvalid))
        h_th.append(th_q)
    db_desc = np.stack(db_desc)
    db_valid = np.stack(db_valid)
    q_desc = np.stack(q_desc)
    q_valid = np.stack(q_valid)
    h_desc = np.stack(h_desc)
    h_valid = np.stack(h_valid)
    train_corpus = db_desc[db_valid]
    print(f"training corpus: {train_corpus.shape[0]} descriptors", flush=True)

    tol = np.deg2rad(args.tol_deg)

    def ang_dist(a, b):
        d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :]) % (2 * np.pi)
        return np.minimum(d, 2 * np.pi - d)

    gt_near = ang_dist(q_th, db_th) <= tol          # [Q, N] correct pairs
    gt_near_h = ang_dist(h_th, db_th) <= tol

    from corbslam.place import database as db_mod

    def evaluate(voc, name):
        db_bow = vocab_mod.transform_many(
            voc, jnp.asarray(db_desc), jnp.asarray(db_valid))

        def retrieval(qd, qv, gt):
            q_bow = vocab_mod.transform_many(voc, jnp.asarray(qd),
                                             jnp.asarray(qv))
            # Score one query per dispatch: the fused [Q, N, W] broadcast
            # of l1_scores_batch is fine at server word counts but OOMs
            # at 32k.
            scores = np.stack([
                np.asarray(vocab_mod.l1_scores(q_bow[i], db_bow))
                for i in range(n)
            ])
            order = np.argsort(-scores, axis=1)
            r1 = gt[np.arange(n)[:, None], order[:, :1]].any(1).mean()
            r5 = gt[np.arange(n)[:, None], order[:, :5]].any(1).mean()
            best_good = np.max(np.where(gt, scores, -np.inf), axis=1)
            best_bad = np.max(np.where(~gt, scores, -np.inf), axis=1)
            # Verified retrieval: rerank the top-5 BoW shortlist by the
            # mutual-NN descriptor match count — the verification every
            # deployed consumer applies before acting on a candidate
            # (reloc SearchByBoW+PnP, loop ComputeSim3, fusion geometric
            # check). This is the retrieval quality of the STACK; the
            # plain recall_at_1 is the vocabulary alone.
            hits = 0
            for i in range(n):
                best, bm = int(order[i, 0]), -1
                for c in order[i, :5]:
                    mc = int(db_mod.count_mutual_matches(
                        jnp.asarray(qd[i]), jnp.asarray(qv[i]),
                        jnp.asarray(db_desc[c]), jnp.asarray(db_valid[c])))
                    if mc > bm:
                        best, bm = int(c), mc
                hits += bool(gt[i, best])
            return r1, r5, float(np.mean(best_good - best_bad)), hits / n

        r1, r5, margin, rv = retrieval(q_desc, q_valid, gt_near)
        h1, h5, hmargin, hv = retrieval(h_desc, h_valid, gt_near_h)
        res = {
            "vocab": name,
            "n_words": int(voc.n_words),
            "recall_at_1": round(float(r1), 4),
            "recall_at_5": round(float(r5), 4),
            "margin_good_vs_bad": round(margin, 4),
            "recall_at_1_verified": round(float(rv), 4),
            "held_out_recall_at_1": round(float(h1), 4),
            "held_out_recall_at_5": round(float(h5), 4),
            "held_out_margin": round(hmargin, 4),
            "held_out_recall_at_1_verified": round(float(hv), 4),
        }
        results[name] = res
        print(json.dumps(res), flush=True)

    results = {}
    for W in args.sizes:
        if W <= 8192:
            voc = vocab_mod.train(jnp.asarray(train_corpus), n_words=W,
                                  n_iters=8)
        else:
            voc = vocab_mod.train_chunked(train_corpus, n_words=W,
                                          n_iters=8, chunk=16384)
        evaluate(voc, str(W))

    # The shipped artifact: trained on UNRELATED worlds (apps/train_vocab),
    # so the room world is fully held out for it — the cross-world
    # generalization evidence the reference gets for free from ORBvoc.
    art = vocab_mod.load_default()
    if art is not None:
        evaluate(art, "artifact32k")
    for p in args.artifacts:
        evaluate(vocab_mod.load_any(p), os.path.basename(p))

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "VOCAB_QUALITY.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
