"""Per-frame diagnosis of the KITTI-turn tracking loss (round 4).

Runs the kitti_scale_probe regime with per-frame state/inlier logging and
relocalization instrumentation to pinpoint WHERE and WHY tracking dies.

Usage: python tools/kitti_turn_diag.py [--frames 250] [--cpu]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument(
        "--world-frames", type=int, default=None,
        help="build the scene for THIS many frames (quad density scales "
        "inversely with world length) but run only --frames of it",
    )
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--unfused", action="store_true",
        help="run the unfused tracking path with per-stage match/inlier logs",
    )
    args = ap.parse_args()
    from orbslam_in_practice.utils import runtime

    runtime.setup(cpu=args.cpu)

    import numpy as np

    from tools.kitti_scale_probe import build
    from orbslam_in_practice.io.evaluation import ate_rmse
    from orbslam_in_practice.slam.tracking import TrackingState
    from orbslam_in_practice.system import SlamSystem
    import orbslam_in_practice.slam.relocalization as reloc_mod

    seq, cfg = build(args.world_frames or args.frames)
    system = SlamSystem(cfg)
    tr = system.tracker

    # instrument relocalize: log candidate counts and inliers
    orig_reloc = reloc_mod.relocalize
    orig_retrieve = reloc_mod._retrieve_candidates

    def retrieve(frame, kf_xy, kf_angle, kf_desc, kf_feat_valid, kf_obs,
                 kf_valid, kf_gdesc, forced, n_cand=reloc_mod.N_CAND):
        cand, matches, counts = orig_retrieve(
            frame, kf_xy, kf_angle, kf_desc, kf_feat_valid, kf_obs,
            kf_valid, kf_gdesc, forced, n_cand,
        )
        import jax as _jax
        c_h, n_h = _jax.device_get((cand, counts))
        fv = _jax.device_get((kf_feat_valid & (kf_obs >= 0)).sum(axis=1))
        nval = int(_jax.device_get(frame.valid.sum()))
        print(
            f"    retrieve frame_valid={nval} cands={list(c_h)} "
            f"counts={list(n_h)} fv={[int(fv[c]) for c in c_h]}",
            flush=True,
        )
        return cand, matches, counts

    reloc_mod._retrieve_candidates = retrieve

    def reloc(tracker, frame):
        out = orig_reloc(tracker, frame)
        ok = out[0]
        print(f"    RELOC ok={ok} n_in={out[3]} kf={out[4]}", flush=True)
        return out

    reloc_mod.relocalize = reloc
    # tracking imported the symbol directly
    import orbslam_in_practice.slam.tracking as tr_mod
    tr_mod.relocalize = reloc

    if args.unfused:
        tr.use_fused = False
        import orbslam_in_practice.slam.tracking as _t

        orig_sbp = _t.search_by_projection

        def sbp(pts, desc, valid, octv, T, frame, K, radius, sf, **kw):
            out = orig_sbp(pts, desc, valid, octv, T, frame, K, radius, sf, **kw)
            nm = int((np.asarray(out[0]) >= 0).sum())
            nv = int(np.asarray(valid).sum())
            print(f"      sbp r={float(np.asarray(radius)):.0f} cand={nv} matches={nm}", flush=True)
            return out

        _t.search_by_projection = sbp

        orig_po = tr._pose_opt_from_matches

        def po(frame, ids_pad, matches, T0):
            out = orig_po(frame, ids_pad, matches, T0)
            print(f"      pose_opt n_in={out[2]}", flush=True)
            return out

        tr._pose_opt_from_matches = po

    t0 = time.time()
    n_tracked = 0
    last_state = None
    for i in range(args.frames):
        pose = system.track_monocular(seq.render(i), i * 0.1)
        if pose is not None and tr.state == TrackingState.OK:
            n_tracked += 1
        st = tr.state.name
        interesting = (
            80 <= i <= 180 or st != "OK" or last_state != st
        )
        if interesting or i % 25 == 0:
            print(
                f"f{i:3d} {st:4.4s} inl={tr.n_inliers:4d} nkf={tr.map.n_kf_active():3d} "
                f"nlm={tr.map.n_lm_active():5d} refkf={tr.ref_kf}",
                flush=True,
            )
        last_state = st
    gt = seq.gt_centers()
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt)
    print(
        f"\ntracked {n_tracked}/{args.frames} ate={rmse:.3f} aligned={n_aligned} "
        f"t={time.time()-t0:.0f}s mapper={tr.mapper.stats()}"
    )


if __name__ == "__main__":
    main()
