"""Global-descriptor variant shoot-out on real rendered orbit frames.

Renders N frames spanning the orbit loop (same world as the slow e2e),
extracts real ORB features, computes several global-descriptor variants, and
scores each by REVISIT CONTRAST: the similarity margin between true-revisit
pairs (nearby camera centers + headings, far apart in time) and unrelated
pairs. This is how the VLAD replacement for mean-of-BRIEF earns its numbers
(VERDICT r3 missing #4, next #5).

Usage: python tools/gdesc_experiment.py
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))



from orbslam_in_practice.utils import runtime

runtime.setup(cpu=True)

import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.frontend.orb import ORBExtractor
from orbslam_in_practice.io.synthetic import SyntheticSequence


def variants(desc_pm1, valid):
    """desc_pm1 (F, 256) ±1 float, valid (F,) bool -> dict of descriptors."""
    d = desc_pm1.astype(np.float32)
    v = valid.astype(np.float32)[:, None]
    out = {}

    # mean of BRIEF (round 1-3)
    m = (d * v).sum(0) / max(v.sum(), 1.0)
    out["mean_brief"] = m / max(np.linalg.norm(m), 1e-9)

    rng = np.random.default_rng(0xC0DEB00C)
    for A in (32, 64, 128):
        anchors = rng.integers(0, 2, (256, A)).astype(np.float32) * 2 - 1
        scores = d @ anchors
        assign = np.argmax(scores, axis=1)
        onehot = np.zeros((len(d), A), np.float32)
        onehot[np.arange(len(d)), assign] = 1.0
        onehot *= v
        sums = onehot.T @ d  # (A, 256)
        counts = onehot.sum(0)

        def norm_stack(vl, key):
            vl = np.sign(vl) * np.sqrt(np.abs(vl))
            n = np.linalg.norm(vl, axis=1, keepdims=True)
            vl = vl / np.maximum(n, 1e-9)
            g = vl.reshape(-1)
            out[key] = g / max(np.linalg.norm(g), 1e-9)

        # vlad with anchor residual (round-4 first cut)
        norm_stack(sums - counts[:, None] * anchors.T, f"vlad_anchor_A{A}")
        # per-cell SUM (no anchor subtraction)
        norm_stack(sums.copy(), f"cellsum_A{A}")
        # per-cell MEAN minus global mean of the image's own descriptors
        gm = (d * v).sum(0) / max(v.sum(), 1.0)
        means = sums / np.maximum(counts[:, None], 1.0)
        norm_stack(
            (means - gm[None, :]) * np.sqrt(np.maximum(counts[:, None], 0.0)),
            f"cellmean_ctr_A{A}",
        )
        # BoW histogram (counts only, L2)
        h = np.sqrt(counts)
        out[f"bow_A{A}"] = h / max(np.linalg.norm(h), 1e-9)
    return out


def main():
    n = 72  # one keyframe every ~4.7 frames of the 340-frame orbit
    seq = SyntheticSequence(
        n_frames=340, n_points=700, kind="orbit", seed=5,
        orbit_step=2 * np.pi / 280,
        depth_range=(3.0, 9.0), spread=(6.0, 5.0),
        noise_sigma=1.0, brightness_jitter=0.1,
    )
    frame_ids = np.linspace(0, 339, n).astype(int)
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=600, n_levels=4,
    )
    ext = ORBExtractor(cfg.n_features, cfg.scale_factor, cfg.n_levels,
                       cfg.ini_th_fast, cfg.min_th_fast, cam=cfg.cam)
    centers = seq.gt_centers()
    fwd = np.stack([T[2, :3] for T in seq.poses])

    descs = {}
    for fi in frame_ids:
        f = ext(jnp.asarray(seq.render(int(fi)), jnp.float32))
        d, v = jax.device_get((f.desc_pm1, f.valid))
        for k, g in variants(d, v).items():
            descs.setdefault(k, []).append(g)

    # labels
    def is_revisit(i, j):
        fi, fj = frame_ids[i], frame_ids[j]
        if abs(int(fi) - int(fj)) < 60:
            return None  # temporally near: excluded (covisible regime)
        dd = np.linalg.norm(centers[fi] - centers[fj])
        ca = float(np.clip(np.dot(fwd[fi], fwd[fj]), -1, 1))
        if dd < 1.0 and np.degrees(np.arccos(ca)) < 30:
            return True
        if dd > 3.0:
            return False
        return None  # gray zone excluded

    pos_pairs, neg_pairs = [], []
    for i in range(n):
        for j in range(i + 1, n):
            lab = is_revisit(i, j)
            if lab is True:
                pos_pairs.append((i, j))
            elif lab is False:
                neg_pairs.append((i, j))
    print(f"pairs: {len(pos_pairs)} true revisits, {len(neg_pairs)} unrelated")

    # centered variants: subtract the SET-WIDE mean descriptor (the common
    # scene-statistics component that compresses cosines toward 1) and
    # renormalize — computable live from the keyframe table at query time
    for k in list(descs.keys()):
        G = np.stack(descs[k])
        Gc = G - G.mean(axis=0, keepdims=True)
        Gc = Gc / np.maximum(np.linalg.norm(Gc, axis=1, keepdims=True), 1e-9)
        descs[k + "_ctr"] = list(Gc)

    print(f"{'variant':<22} {'pos_mean':>8} {'neg_mean':>8} {'neg_p99':>8} "
          f"{'margin':>8} {'top1_acc':>8}")
    for k, gl in descs.items():
        G = np.stack(gl)
        S = G @ G.T
        pos = np.array([S[i, j] for i, j in pos_pairs])
        neg = np.array([S[i, j] for i, j in neg_pairs])
        # retrieval accuracy: for each query with a true revisit, is the
        # top-ranked non-near candidate a true revisit?
        hits = tot = 0
        for i in range(n):
            true_js = [j for (a, j) in pos_pairs if a == i] + [
                a for (a, j) in pos_pairs if j == i
            ]
            if not true_js:
                continue
            cand_js = [
                j for j in range(n)
                if j != i and abs(int(frame_ids[i]) - int(frame_ids[j])) >= 60
            ]
            best = max(cand_js, key=lambda j: S[i, j])
            tot += 1
            hits += best in true_js
        print(
            f"{k:<22} {pos.mean():8.3f} {neg.mean():8.3f} "
            f"{np.percentile(neg, 99):8.3f} "
            f"{pos.mean() - np.percentile(neg, 99):8.3f} {hits / max(tot, 1):8.2f}"
        )


if __name__ == "__main__":
    main()
