"""Sweep BoW SCORING variants on the held-out place-recognition eval.

Corpus/W scaling saturated below the r5 target (bigger corpus 0.78, 64k
words 0.71 vs 0.79 for the shipped artifact): the residual held-out-recall
gap is not the quantizer but the SCORE — synthetic textures are repetitive,
so raw tf histograms are bursty and L1-tf-idf rewards the burst, not the
place. This tool renders the tools/vocab_quality.py eval once, caches the
descriptor sets, assigns words once with the artifact, then evaluates
scoring variants (tf vs binary presence, idf exponents, L1 vs cosine,
stopword trimming) in milliseconds each.

Run: python -u tools/vocab_score_sweep.py [--cache /tmp/vq_cache.npz]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def render_sets(cache_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from corbslam import compile_cache

    compile_cache.configure()
    import jax.numpy as jnp

    from corbslam.config import OrbConfig, SlamConfig
    from corbslam.frontend import frame as frame_mod
    from corbslam.geometry import camera, se3
    from corbslam.io import synthetic

    cam = camera.Intrinsics.create(
        fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
        width=320, height=240,
    )
    cfg = SlamConfig(orb=OrbConfig(n_features=512, n_levels=4, cell_size=12))
    world = synthetic.MultiPlaneWorld.room(
        cam, half=14.0, height=3.0, noise_std=3.0, seed=2)
    n = 72
    step = 2 * np.pi / n

    def pose(th, radius=5.0):
        Twc = se3.compose(
            se3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
            se3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -radius])),
        )
        return se3.inverse(Twc)

    sets = {k: [] for k in ("db_desc", "db_valid", "db_th",
                            "q_desc", "q_valid", "q_th",
                            "h_desc", "h_valid", "h_th")}
    for i in range(n):
        th = step * i
        for tag, th_i, r, fr in (("db", th, 5.0, i),
                                 ("q", th + 0.5 * step, 5.0, 1000 + i),
                                 ("h", th + 0.5 * step, 7.5, 2000 + i)):
            img, _ = world.render_stereo(pose(th_i, r), frame=fr)
            f = frame_mod.build_frame_mono(img, cam, cfg.orb)
            sets[tag + "_desc"].append(np.asarray(f.desc))
            sets[tag + "_valid"].append(np.asarray(f.fvalid))
            sets[tag + "_th"].append(th_i)
        if i % 12 == 0:
            print(f"rendered {i}/{n}", flush=True)
    np.savez_compressed(cache_path, **{k: np.stack(v) if "desc" in k or
                                       "valid" in k else np.asarray(v)
                                       for k, v in sets.items()})
    return np.load(cache_path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default="/tmp/vq_cache.npz")
    ap.add_argument("--vocab", default=None,
                    help="vocabulary npz (default: shipped artifact)")
    ap.add_argument("--tol-deg", type=float, default=12.0)
    args = ap.parse_args()

    if os.path.exists(args.cache):
        z = np.load(args.cache)
    else:
        z = render_sets(args.cache)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from corbslam.ops import descriptors as D
    from corbslam.place import vocab as V

    voc = (V.load_any(args.vocab) if args.vocab else V.load_default())
    W = voc.n_words

    def words_of(desc, valid):
        out = []
        for i in range(desc.shape[0]):
            bits = D.unpack_bits(jnp.asarray(desc[i]))
            w = np.array(V._assign_tree(bits, voc) if voc.child_idx
                         is not None else V._assign(bits, voc.word_bits))
            w[~valid[i]] = -1
            out.append(w)
        return np.stack(out)

    print("assigning words ...", flush=True)
    w_db = words_of(z["db_desc"], z["db_valid"])
    w_q = words_of(z["q_desc"], z["q_valid"])
    w_h = words_of(z["h_desc"], z["h_valid"])

    def hist(wmat):
        h = np.zeros((wmat.shape[0], W), np.float32)
        for i, row in enumerate(wmat):
            ids, cnt = np.unique(row[row >= 0], return_counts=True)
            h[i, ids] = cnt
        return h

    h_db, h_q, h_h = hist(w_db), hist(w_q), hist(w_h)
    idf = np.asarray(voc.idf)
    df = (h_db > 0).sum(0)  # document frequency over the db lap

    def ang_dist(a, b):
        d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :]) % (2 * np.pi)
        return np.minimum(d, 2 * np.pi - d)

    tol = np.deg2rad(args.tol_deg)
    gt_q = ang_dist(z["q_th"], z["db_th"]) <= tol
    gt_h = ang_dist(z["h_th"], z["db_th"]) <= tol

    def recall(scores, gt):
        order = np.argsort(-scores, axis=1)
        n = scores.shape[0]
        r1 = gt[np.arange(n)[:, None], order[:, :1]].any(1).mean()
        r5 = gt[np.arange(n)[:, None], order[:, :5]].any(1).mean()
        return float(r1), float(r5)

    def l1_normalize(v):
        return v / np.maximum(np.abs(v).sum(1, keepdims=True), 1e-9)

    def l2_normalize(v):
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)

    def eval_variant(name, tf_fn, weight, score):
        vdb, vq, vh = tf_fn(h_db) * weight, tf_fn(h_q) * weight, tf_fn(h_h) * weight
        if score == "l1":
            vdb, vq, vh = l1_normalize(vdb), l1_normalize(vq), l1_normalize(vh)
            s_q = np.minimum(vq[:, None, :], vdb[None, :, :]).sum(-1)
            s_h = np.minimum(vh[:, None, :], vdb[None, :, :]).sum(-1)
        else:  # cosine
            vdb, vq, vh = l2_normalize(vdb), l2_normalize(vq), l2_normalize(vh)
            s_q = vq @ vdb.T
            s_h = vh @ vdb.T
        r1q, r5q = recall(s_q, gt_q)
        r1h, r5h = recall(s_h, gt_h)
        print(json.dumps({"variant": name, "easy_r1": round(r1q, 4),
                          "hard_r1": round(r1h, 4), "hard_r5": round(r5h, 4)}),
              flush=True)

    ident = lambda h: h
    binary = lambda h: (h > 0).astype(np.float32)
    log1p = lambda h: np.log1p(h)
    sqrt = lambda h: np.sqrt(h)
    eval_variant("tf*idf L1 (current)", ident, idf, "l1")
    eval_variant("tf*idf cos", ident, idf, "cos")
    eval_variant("binary*idf L1", binary, idf, "l1")
    eval_variant("binary*idf cos", binary, idf, "cos")
    eval_variant("log1p*idf L1", log1p, idf, "l1")
    eval_variant("sqrt*idf L1", sqrt, idf, "l1")
    eval_variant("sqrt*idf cos", sqrt, idf, "cos")
    eval_variant("tf (no idf) L1", ident, np.ones(W, np.float32), "l1")
    eval_variant("binary (no idf) L1", binary, np.ones(W, np.float32), "l1")
    eval_variant("binary*idf^2 L1", binary, idf ** 2, "l1")
    eval_variant("tf*idf^2 L1", ident, idf ** 2, "l1")
    # db-local idf (reference recomputes weights per database? no — but a
    # deployment KFDB knows its own df; measure the headroom)
    idf_db = np.log(h_db.shape[0] / np.maximum(df, 1)).astype(np.float32)
    eval_variant("tf*dbidf L1", ident, idf_db, "l1")
    eval_variant("binary*dbidf L1", binary, idf_db, "l1")
    # stopword trimming: zero the most corpus-frequent words
    for pct in (1, 5, 10):
        k = max(1, W * pct // 100)
        stop = np.argsort(-df)[:k]
        wgt = idf.copy()
        wgt[stop] = 0.0
        eval_variant(f"tf*idf L1 stop{pct}%", ident, wgt, "l1")
        eval_variant(f"binary*idf L1 stop{pct}%", binary, wgt, "l1")

    # ---- soft assignment: each descriptor votes for its 2 nearest words
    # with distance-decayed weights (quantization-error smoothing under
    # viewpoint/scale change) -----------------------------------------
    import jax as _jax

    @_jax.jit
    def top2(desc):
        bits = D.unpack_bits(desc)
        d = D.hamming_matrix_bits(bits, voc.word_bits)
        nd, ni = _jax.lax.top_k(-d, 2)
        return ni, -nd

    def soft_hist(desc, valid, beta):
        h = np.zeros((desc.shape[0], W), np.float32)
        for i in range(desc.shape[0]):
            ids, dist = top2(jnp.asarray(desc[i]))
            ids, dist = np.asarray(ids), np.asarray(dist, np.float32)
            wts = np.exp(-beta * (dist - dist[:, :1]))
            wts[~valid[i]] = 0.0
            for k in range(2):
                np.add.at(h[i], ids[:, k], wts[:, k])
        return h

    for beta in (0.05, 0.1, 0.2):
        s_db = soft_hist(z["db_desc"], z["db_valid"], beta)
        s_q = soft_hist(z["q_desc"], z["q_valid"], beta)
        s_h = soft_hist(z["h_desc"], z["h_valid"], beta)
        hh_db, hh_q, hh_h = h_db, h_q, h_h
        try:
            # reuse eval_variant machinery on the soft histograms
            h_dbL, h_qL, h_hL = s_db, s_q, s_h
            for score in ("l1", "cos"):
                vdb = l1_normalize(h_dbL * idf) if score == "l1" else \
                    l2_normalize(h_dbL * idf)
                vq = l1_normalize(h_qL * idf) if score == "l1" else \
                    l2_normalize(h_qL * idf)
                vh = l1_normalize(h_hL * idf) if score == "l1" else \
                    l2_normalize(h_hL * idf)
                if score == "l1":
                    s_qm = np.minimum(vq[:, None, :], vdb[None, :, :]).sum(-1)
                    s_hm = np.minimum(vh[:, None, :], vdb[None, :, :]).sum(-1)
                else:
                    s_qm = vq @ vdb.T
                    s_hm = vh @ vdb.T
                r1q, _ = recall(s_qm, gt_q)
                r1h, r5h = recall(s_hm, gt_h)
                print(json.dumps({"variant": f"soft2(b={beta})*idf {score}",
                                  "easy_r1": round(r1q, 4),
                                  "hard_r1": round(r1h, 4),
                                  "hard_r5": round(r5h, 4)}), flush=True)
        finally:
            h_db, h_q, h_h = hh_db, hh_q, hh_h

    # ---- top-5 shortlist + direct descriptor re-rank (what the deployed
    # loop/reloc path does after BoW: SearchByBoW + geometric verify) ---
    def rerank(h_q_, wq, gt, name):
        vdb = l2_normalize(h_db * idf)
        vq = l2_normalize(h_q_ * idf)
        s = vq @ vdb.T
        order = np.argsort(-s, axis=1)[:, :5]
        n = s.shape[0]
        hits = 0
        for i in range(n):
            best, best_m = -1, -1
            qd = wq[i][wq[i] >= 0]
            for c in order[i]:
                cd = w_db[c][w_db[c] >= 0]
                inter = np.intersect1d(qd, cd).size
                if inter > best_m:
                    best, best_m = c, inter
            hits += bool(gt[i, best])
        print(json.dumps({"variant": name, "hard_r1": round(hits / n, 4)}),
              flush=True)

    rerank(h_h, w_h, gt_h, "cos top5 + shared-word rerank")


if __name__ == "__main__":
    main()
