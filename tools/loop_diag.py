"""Diagnose the kitti_loop zero-closure run (round 5): per keyframe on the
revisit leg, record what retrieval returned, what Sim3 did with it, and
whether tracking had already bridged the loop implicitly (covisible old-seq
keyframes) — distinguishing 'retrieval missed' / 'Sim3 rejected' /
'implicitly closed before the explicit path could fire'.

Usage: timeout 4000 python tools/loop_diag.py [--frames 600]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=580)
    ap.add_argument("--step", type=float, default=0.35)
    ap.add_argument("--noise", type=float, default=4.0)
    ap.add_argument("--jitter", type=float, default=0.15)
    ap.add_argument("--json-out", default="loop_diag.json")
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup()

    from tools.kitti_scale_probe import build
    from orbslam_in_practice.slam.place_recognition import center as pr_center
    from orbslam_in_practice.slam.tracking import TrackingState
    from orbslam_in_practice.system import SlamSystem

    seq, cfg = build(
        args.frames, kind="kitti_loop", step=args.step,
        noise_sigma=args.noise, brightness_jitter=args.jitter,
    )
    system = SlamSystem(cfg)
    tr = system.tracker
    lc = tr.loop_closer
    smap = system.map

    # class-level wraps: reset() replaces tr.loop_closer mid-run
    from orbslam_in_practice.slam.loop_closing import LoopCloser

    events = []
    orig_detect = LoopCloser.detect_candidates
    orig_sim3 = LoopCloser.compute_sim3

    def detect_logged(self, smap_, kf_id, n_cand=3):
        cands = orig_detect(self, smap_, kf_id, n_cand)
        cur_seq = int(smap_.kf_seq[kf_id])
        # implicit bridge: covisible keyframes much older than the guard
        covis_row = smap_.covisibility()[kf_id]
        nbs = np.nonzero(covis_row >= 15)[0]
        old_nbs = [
            (int(j), int(smap_.kf_seq[j]), int(covis_row[j]))
            for j in nbs
            if cur_seq - int(smap_.kf_seq[j]) >= 30
        ]
        # raw top-5 centered similarity (pre-filtering)
        kf_valid = smap_.kf_valid_host()[: smap_.n_kf]
        g = pr_center(smap_.hview("kf_gdesc")[: smap_.n_kf], kf_valid)
        sims = g @ g[kf_id]
        top5 = [
            (int(j), float(sims[j]), int(smap_.kf_seq[j]))
            for j in np.argsort(-sims)[:5]
            if kf_valid[j] and j != kf_id
        ]
        events.append(
            {
                "frame": tr.frame_id,
                "kf": int(kf_id),
                "seq": cur_seq,
                "cands": [int(c) for c in cands],
                "cand_seqs": [int(smap_.kf_seq[c]) for c in cands],
                "old_covis_nbs": old_nbs[:8],
                "top5_sims": top5,
            }
        )
        return cands

    def sim3_logged(self, smap_, kf_id, cand):
        out = orig_sim3(self, smap_, kf_id, cand)
        events[-1].setdefault("sim3", []).append(
            {"cand": int(cand), "ok": bool(out[0]), "n_inl": int(out[4])}
        )
        return out

    LoopCloser.detect_candidates = detect_logged
    LoopCloser.compute_sim3 = sim3_logged

    n_tracked = 0
    for i in range(args.frames):
        pose = system.track_monocular(seq.render(i), i * 0.1)
        if pose is not None and tr.state == TrackingState.OK:
            n_tracked += 1

    summary = {
        "tracked": n_tracked / args.frames,
        "n_closures": tr.loop_closer.n_closures,
        "n_kf_inserts_with_diag": len(events),
        # only the interesting tail (revisit leg) in full
        "revisit_events": [e for e in events if e["frame"] >= 440],
        "n_events_with_cands": sum(1 for e in events if e["cands"]),
        "n_events_with_old_covis": sum(1 for e in events if e["old_covis_nbs"]),
    }
    with open(args.json_out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "revisit_events"}, indent=2))
    for e in summary["revisit_events"][:40]:
        print(json.dumps(e))


if __name__ == "__main__":
    main()
