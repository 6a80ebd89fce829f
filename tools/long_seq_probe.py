"""Probe: long orbit sequence to observe slot recycling / plateau behavior.

Usage: JAX_PLATFORMS=cpu python tools/long_seq_probe.py [n_frames]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

from orbslam_in_practice.utils import runtime

runtime.setup(cpu=True)

import numpy as np

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.slam.tracking import TrackingState
from orbslam_in_practice.system import SlamSystem


def main(n_frames=250):
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=500, n_levels=4, fps=10.0,
        k_max=96, l_max=4096, ba_lm_budget=1024, ba_obs_budget=4096,
        enable_loop_closing=True,
    )
    seq = SyntheticSequence(
        n_frames=n_frames, n_points=1600, kind="orbit", seed=5,
        orbit_step=2 * np.pi / 180.0,
    )
    sys_ = SlamSystem(cfg)
    t0 = time.time()
    n_tracked = 0
    n_lost = 0
    for i in range(n_frames):
        pose = sys_.track_monocular(seq.render(i), i * 0.1)
        if pose is not None:
            n_tracked += 1
        if sys_.state == TrackingState.LOST:
            n_lost += 1
        if i % 25 == 0 or i == n_frames - 1:
            st = sys_.map.stats()
            lc = sys_.tracker.loop_closer
            print(
                f"f{i:4d} state={sys_.state.name:14s} tracked={n_tracked} "
                f"kf={st['n_kf']}/{st['kf_slots_hw']} lm={st['n_lm']}/{st['lm_slots_hw']} "
                f"free(kf={st['kf_free']},lm={st['lm_free']}) "
                f"closures={lc.n_closures if lc else 0} "
                f"t={time.time()-t0:.0f}s",
                flush=True,
            )
    rmse, n_aligned, cov = ate_rmse(sys_.get_trajectory(), seq.gt_centers())
    print(
        f"DONE frames={n_frames} tracked={n_tracked} lost_frames={n_lost} "
        f"ATE={rmse:.4f} aligned={n_aligned} "
        f"ba_truncations={sys_.tracker.mapper.n_ba_truncations} "
        f"wall={time.time()-t0:.0f}s"
    )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 350)
