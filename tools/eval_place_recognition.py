"""Place-recognition quality evaluation (VERDICT r2 missing #5).

The mean-of-BRIEF global descriptor replaces DBoW2 wholesale, so it carries
its own burden of proof. This tool runs the orbit sequence (the loop-closure
regime of tests/test_e2e_long_sequence.py), instruments LoopCloser, and
scores every retrieval candidate against GROUND-TRUTH revisit labels derived
from the true camera poses: a (query, candidate) pair is a true revisit when
the true camera centers are within `dist_th` and the headings within
`yaw_th` degrees.

Reported:
  - retrieval precision/recall at the operating threshold
    (detect_candidates' adaptive min_score + temporal/covisibility gates);
  - post-geometric-verification precision (after Sim3-RANSAC, the number
    that actually guards the map against false closures);
  - closure recall: fraction of queries with a true revisit available where
    the WHOLE pipeline (retrieval + Sim3) accepted a true pair.

Usage: python tools/eval_place_recognition.py [--frames 340]
(CPU is fine — the numbers are about correctness, not latency.)
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
    ap.add_argument("--json-out", default=None)
    ap.add_argument(
        "--gate", action="store_true",
        help="assert retrieval query-recall >= 0.5 and post-Sim3 precision "
        "== 1.0 (pair with --detect-only for the fair retrieval benchmark)",
    )
    ap.add_argument(
        "--detect-only", action="store_true",
        help="verify Sim3 but skip the map correction: the live system stops "
        "being a fair retrieval benchmark after its FIRST closure (the "
        "corrected+fused map makes later revisits covisible, so they are "
        "excluded by design); this mode keeps drift so every revisit query "
        "tests retrieval",
    )
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup(cpu=True)

    from orbslam_in_practice.config import SlamConfig
    from orbslam_in_practice.io.synthetic import SyntheticSequence
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

    # ground truth per frame: camera center + viewing direction
    centers = seq.gt_centers()
    fwd = np.stack([T[2, :3] for T in seq.poses])  # camera z axis in world

    def is_revisit(fi, fj):
        if fi < 0 or fj < 0:
            return False
        d = np.linalg.norm(centers[fi] - centers[fj])
        cosang = float(np.clip(np.dot(fwd[fi], fwd[fj]), -1, 1))
        return d < args.dist_th and np.degrees(np.arccos(cosang)) < args.yaw_th

    # instrument: record every retrieval candidate and every Sim3 verdict
    events = []  # (query_frame, cand_frame, retrieved, sim3_ok)
    orig_detect = lc.detect_candidates
    orig_sim3 = lc.compute_sim3

    def detect(smap, kf_id, n_cand=3):
        cands = orig_detect(smap, kf_id, n_cand)
        qf = int(smap.kf_frame_id[kf_id])
        for c in cands:
            events.append(
                {"q": qf, "c": int(smap.kf_frame_id[c]), "kf": kf_id,
                 "cand": c, "sim3": None}
            )
        return cands

    def sim3(smap, kf_id, cand):
        out = orig_sim3(smap, kf_id, cand)
        for e in events:
            if e["kf"] == kf_id and e["cand"] == cand and e["sim3"] is None:
                e["sim3"] = bool(out[0])
        return out

    lc.detect_candidates = detect
    lc.compute_sim3 = sim3
    if args.detect_only:
        n_would_close = [0]

        def no_close(smap, kf_id, cand, s, R, t, run_global_ba=True):
            n_would_close[0] += 1
            return True  # accepted, but no correction applied

        lc.close_loop = no_close

    # also track, per query keyframe, whether a true revisit EXISTED among
    # the valid non-covisible older keyframes (recall denominator)
    queries_with_gt = 0
    queries_retrieved_true = 0
    queries_closed_true = 0
    orig_attempt = lc.attempt

    def attempt(smap, kf_id):
        nonlocal queries_with_gt, queries_retrieved_true, queries_closed_true
        qf = int(smap.kf_frame_id[kf_id])
        kf_valid = smap.kf_valid_host()
        cur_seq = int(smap.kf_seq[kf_id])
        has_gt = any(
            kf_valid[j]
            and abs(cur_seq - int(smap.kf_seq[j])) >= 10
            and is_revisit(qf, int(smap.kf_frame_id[j]))
            for j in range(smap.n_kf)
        )
        n_ev0 = len(events)
        closed = orig_attempt(smap, kf_id)
        new = events[n_ev0:]
        if has_gt:
            queries_with_gt += 1
            if any(is_revisit(e["q"], e["c"]) for e in new):
                queries_retrieved_true += 1
            if closed and any(
                e["sim3"] and is_revisit(e["q"], e["c"]) for e in new
            ):
                queries_closed_true += 1
        return closed

    lc.attempt = attempt

    for i in range(n):
        system.track_monocular(seq.render(i), i * 0.1)

    for e in events:
        e["gt"] = is_revisit(e["q"], e["c"])

    n_ret = len(events)
    tp_ret = sum(e["gt"] for e in events)
    verified = [e for e in events if e["sim3"]]
    tp_ver = sum(e["gt"] for e in verified)
    out = {
        "frames": n,
        "n_keyframe_queries_with_gt_revisit": queries_with_gt,
        "retrieval": {
            "candidates": n_ret,
            "true": tp_ret,
            "precision": tp_ret / n_ret if n_ret else None,
            "query_recall": queries_retrieved_true / queries_with_gt
            if queries_with_gt else None,
        },
        "post_sim3": {
            "accepted": len(verified),
            "true": tp_ver,
            "precision": tp_ver / len(verified) if verified else None,
            "query_recall": queries_closed_true / queries_with_gt
            if queries_with_gt else None,
        },
        "n_closures": lc.n_closures,
        "thresholds": {"dist": args.dist_th, "yaw_deg": args.yaw_th},
    }
    print(json.dumps(out, indent=2, default=float))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2, default=float)
    if args.gate:
        # VERDICT r3 next #5 gates (measured r4: recall 0.846, precision 1.0
        # in --detect-only mode)
        ret_recall = out["retrieval"]["query_recall"] or 0.0
        ver_prec = out["post_sim3"]["precision"]
        assert ret_recall >= 0.5, f"retrieval query_recall {ret_recall} < 0.5"
        assert ver_prec is None or ver_prec == 1.0, (
            f"post-Sim3 precision {ver_prec} != 1.0"
        )
        print("GATES PASSED")


if __name__ == "__main__":
    main()
