"""ATE evaluation: Sim(3)-aligned RMSE against ground truth.

The standard TUM evaluation (SURVEY.md §4.3): associate estimated and
ground-truth poses by timestamp, align with a similarity transform (monocular
scale is unobservable), report translational RMSE.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from orbslam_in_practice.geometry.sim3 import horn_sim3


def ate_rmse(
    est: list,
    gt_positions: np.ndarray,
    gt_ids: np.ndarray | None = None,
    align_scale: bool = True,
):
    """ATE RMSE between an estimated trajectory and ground truth.

    Args:
      est: [(frame_id, ts, Tcw or None), ...] (SlamSystem.get_trajectory()).
      gt_positions: (T, 3) ground-truth camera centers, indexed by frame id
        (or by gt_ids when given).
      align_scale: Sim3 (True, monocular) or SE3 alignment.

    Returns (rmse, n_aligned, coverage_fraction).
    """
    ids, centers = [], []
    for fid, _, Tcw in est:
        if Tcw is None:
            continue
        Twc = np.linalg.inv(Tcw)
        ids.append(fid)
        centers.append(Twc[:3, 3])
    if len(ids) < 3:
        return float("inf"), 0, 0.0
    ids = np.asarray(ids)
    centers = np.asarray(centers, np.float32)
    if gt_ids is None:
        gt_ids = np.arange(len(gt_positions))
    lookup = {int(g): i for i, g in enumerate(gt_ids)}
    keep = np.array([int(i) in lookup for i in ids])
    ids, centers = ids[keep], centers[keep]
    gt = np.asarray(
        [gt_positions[lookup[int(i)]] for i in ids], np.float32
    )
    s, R, t = horn_sim3(
        jnp.asarray(centers), jnp.asarray(gt), with_scale=align_scale
    )
    aligned = float(s) * centers @ np.asarray(R).T + np.asarray(t)
    err = np.linalg.norm(aligned - gt, axis=-1)
    rmse = float(np.sqrt(np.mean(err**2)))
    coverage = len(ids) / max(len(est), 1)
    return rmse, len(ids), coverage
