"""Where do TRUE revisit candidates die in the Sim3 stage? (VERDICT r4
next #6: the closure-stage query-recall cap moved from retrieval — now
0.85 on the orbit labels — to Sim3 verification, 0.23.)

Runs the eval_place_recognition orbit in detect-only mode and logs, for
every (query, candidate) pair with a ground-truth label, the Sim3 funnel:
raw descriptor matches -> RANSAC round-1 inliers -> guided growth size ->
final inliers -> verdict. Prints the funnel split by gt truth.

Usage: timeout 3000 python tools/sim3_recall_probe.py [--frames 340]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=340)
    ap.add_argument("--dist-th", type=float, default=1.0)
    ap.add_argument("--yaw-th", type=float, default=30.0)
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup(cpu=True)

    from orbslam_in_practice.config import SlamConfig
    from orbslam_in_practice.io.synthetic import SyntheticSequence
    from orbslam_in_practice.slam import loop_closing as lc_mod
    from orbslam_in_practice.system import SlamSystem

    n = args.frames
    seq = SyntheticSequence(
        n_frames=n, n_points=700, kind="orbit", seed=5,
        orbit_step=2 * np.pi / 280,
        depth_range=(3.0, 9.0), spread=(6.0, 5.0),
        noise_sigma=1.0, brightness_jitter=0.1,
    )
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=600, n_levels=4, fps=10.0, k_max=48, l_max=4096,
    )
    system = SlamSystem(cfg)
    tr = system.tracker
    lc = tr.loop_closer

    centers = seq.gt_centers()
    fwd = np.stack([T[2, :3] for T in seq.poses])

    def is_revisit(fi, fj):
        d = np.linalg.norm(centers[fi] - centers[fj])
        cosang = float(np.clip(np.dot(fwd[fi], fwd[fj]), -1, 1))
        return bool(d < args.dist_th and np.degrees(np.arccos(cosang)) < args.yaw_th)

    funnel = []
    orig_cs = lc.compute_sim3
    orig_rp = lc._ransac_pairs
    orig_gp = lc._guided_pairs
    state = {}

    def rp(smap, pairs, kf_id, cand, key):
        out = orig_rp(smap, pairs, kf_id, cand, key)
        state.setdefault("rounds", []).append((len(pairs), int(out[3])))
        return out

    def gp(smap, kf_id, cand, s, R, t):
        out = orig_gp(smap, kf_id, cand, s, R, t)
        state["grown"] = len(out)
        return out

    def cs(smap, kf_id, cand):
        state.clear()
        state["rounds"] = []
        ok, s, R, t, n_inl = orig_cs(smap, kf_id, cand)
        funnel.append(
            {
                "q": int(smap.kf_frame_id[kf_id]),
                "c": int(smap.kf_frame_id[cand]),
                "rounds": state.get("rounds", []),
                "grown": state.get("grown", 0),
                "final": int(n_inl),
                "ok": bool(ok),
            }
        )
        return ok, s, R, t, n_inl

    lc.compute_sim3 = cs
    lc._ransac_pairs = rp
    lc._guided_pairs = gp
    lc.close_loop = lambda *a, **k: True  # detect-only

    for i in range(n):
        system.track_monocular(seq.render(i), i * 0.1)

    for e in funnel:
        e["gt"] = is_revisit(e["q"], e["c"])
    true_f = [e for e in funnel if e["gt"]]
    false_f = [e for e in funnel if not e["gt"]]
    print(f"TRUE candidates ({len(true_f)}):")
    for e in true_f:
        print(" ", json.dumps(e))
    print(f"FALSE candidates ({len(false_f)}): accepted {sum(e['ok'] for e in false_f)}")
    fr1 = [e["rounds"][0][1] for e in false_f if e["rounds"]]
    if fr1:
        print(
            "  false round-1 inliers: median %.0f max %d"
            % (np.median(fr1), max(fr1))
        )
    n0 = sum(1 for e in false_f if not e["rounds"])
    print(f"  false with <MIN raw matches (early out): {n0}")


if __name__ == "__main__":
    main()
