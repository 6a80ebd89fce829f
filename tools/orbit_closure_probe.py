"""Probe: replicate test_long_orbit_recycles_and_closes_loop exactly and
log the loop-closure pipeline stage by stage to find where it dies
(VERDICT r3 missing #1: zero closures in independent runs).

Usage: python tools/orbit_closure_probe.py [n_frames]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from orbslam_in_practice.utils import runtime

runtime.setup(cpu=True)

import numpy as np

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.slam.tracking import TrackingState
from orbslam_in_practice.system import SlamSystem

K_MAX = 48
L_MAX = 4096


def main(n_frames=340):
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        width=640, height=480,
        n_features=600, n_levels=4, fps=10.0,
        k_max=K_MAX, l_max=L_MAX,
    )
    seq = SyntheticSequence(
        n_frames=n_frames, n_points=700, kind="orbit", seed=5,
        orbit_step=2 * np.pi / 280,
        depth_range=(3.0, 9.0), spread=(6.0, 5.0),
        noise_sigma=1.0, brightness_jitter=0.1,
    )
    sys_ = SlamSystem(cfg)
    tr = sys_.tracker
    lc = tr.loop_closer

    # instrument the closure pipeline
    orig_detect = lc.detect_candidates
    orig_sim3 = lc.compute_sim3

    log = []

    def detect_candidates(smap, kf_id, n_cand=3):
        cands = orig_detect(smap, kf_id, n_cand)
        g = lc._global_descriptors(smap)
        sims = g @ g[kf_id]
        covis = smap.covisibility()
        neighbors = set(np.nonzero(covis[kf_id] >= 15)[0].tolist()) | {kf_id}
        nb_scores = [sims[j] for j in neighbors if j != kf_id]
        min_score = max(min(nb_scores) if nb_scores else 0.3, 0.2)
        # best non-neighbor similarity regardless of gates
        kf_valid = smap.kf_valid_host()
        cur_seq = int(smap.kf_seq[kf_id])
        best_j, best_s = -1, -1.0
        for j in range(smap.n_kf):
            if j in neighbors or not kf_valid[j]:
                continue
            if abs(cur_seq - int(smap.kf_seq[j])) < 10:
                continue
            if sims[j] > best_s:
                best_s, best_j = float(sims[j]), j
        log.append(
            dict(kf=kf_id, seq=cur_seq, min_score=float(min_score),
                 best_j=best_j, best_s=best_s, n_cand=len(cands))
        )
        return cands

    def compute_sim3(smap, kf_id, cand):
        ok, s, R, t, n_inl = orig_sim3(smap, kf_id, cand)
        log.append(dict(kf=kf_id, sim3_cand=cand, ok=bool(ok), n_inl=int(n_inl)))
        return ok, s, R, t, n_inl

    orig_close = lc.close_loop

    def close_loop(smap, kf_id, cand, s, R, t, run_global_ba=True):
        kfs = smap.valid_keyframes_by_seq()
        before = smap.hview("kf_pose")[kfs].copy()
        centers_b = -np.einsum(
            "kij,kj->ki", before[:, :3, :3].transpose(0, 2, 1), before[:, :3, 3]
        )
        out = orig_close(smap, kf_id, cand, s, R, t, run_global_ba)
        after = smap.hview("kf_pose")[kfs]
        centers_a = -np.einsum(
            "kij,kj->ki", after[:, :3, :3].transpose(0, 2, 1), after[:, :3, 3]
        )
        d = np.linalg.norm(centers_a - centers_b, axis=1)
        print(
            f"  CLOSE kf={kf_id}(seq {int(smap.kf_seq[kf_id])}, frame "
            f"{int(smap.kf_frame_id[kf_id])}) vs cand={cand}(seq "
            f"{int(smap.kf_seq[cand])}, frame {int(smap.kf_frame_id[cand])}) "
            f"s={s:.4f} |dc| mean={d.mean():.3f} max={d.max():.3f}",
            flush=True,
        )
        return out

    lc.detect_candidates = detect_candidates
    lc.compute_sim3 = compute_sim3
    lc.close_loop = close_loop

    gt_all = seq.gt_centers()
    t0 = time.time()
    n_tracked = 0
    ate_pre = None
    pre_snapshot = None
    n_closures_seen = 0
    for i in range(n_frames):
        if lc.n_closures == 0:
            pre_snapshot = list(sys_.get_trajectory())
        if sys_.track_monocular(seq.render(i), i * 0.1) is not None:
            n_tracked += 1
        if lc.n_closures >= 1 and ate_pre is None and pre_snapshot:
            ate_pre = ate_rmse(pre_snapshot, gt_all)[0]
        if lc.n_closures > n_closures_seen:
            n_closures_seen = lc.n_closures
            r_now = ate_rmse(sys_.get_trajectory(), gt_all)[0]
            print(f"f{i:3d} CLOSURE #{n_closures_seen}: running ate={r_now:.3f}", flush=True)
        if i % 20 == 0:
            r_now = ate_rmse(sys_.get_trajectory(), gt_all)[0] if i > 20 else 0.0
            print(
                f"f{i:3d} state={sys_.state.name} inl={tr.n_inliers} "
                f"nkf={tr.map.n_kf_active()} nlm={tr.map.n_lm_active()} "
                f"closures={lc.n_closures} ate={r_now:.3f} t={time.time()-t0:.0f}s",
                flush=True,
            )
    print(f"\ntracked {n_tracked}/{n_frames}, closures={lc.n_closures}")
    insertions = int(np.asarray(tr.map.kf_seq).max()) + 1
    print(f"kf insertions={insertions} active={tr.map.n_kf_active()}")
    gt = seq.gt_centers()
    rmse, n_aligned, _ = ate_rmse(sys_.get_trajectory(), gt)
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    print(f"ate={rmse:.3f} ({100*rmse/path_len:.2f}% of {path_len:.1f} m), aligned={n_aligned}")
    if ate_pre is not None:
        print(f"ate_pre={ate_pre:.3f} (test gates: rmse < 0.6*ate_pre and < 1% path)")

    print("\n--- closure pipeline log ---")
    for e in log:
        if "sim3_cand" in e:
            print(f"  kf={e['kf']} SIM3 vs {e['sim3_cand']}: ok={e['ok']} n_inl={e['n_inl']}")
        else:
            print(
                f"kf={e['kf']:3d} seq={e['seq']:3d} min_score={e['min_score']:.3f} "
                f"best_nonneighbor={e['best_j']:3d} sim={e['best_s']:.3f} cands={e['n_cand']}"
            )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 340)
