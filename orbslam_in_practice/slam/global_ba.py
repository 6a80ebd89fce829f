"""Full-map (global) bundle adjustment over the array map.

The reference's GlobalBundleAdjustemnt [sic] (src/Optimizer.cpp:14-21) ran
over the whole map but never wrote results back (:127-128); here it does,
with chi2 scrubbing. Used after loop closure (original ORB-SLAM runs it in a
background thread; this engine runs it synchronously — determinism first)
and available through SlamSystem for offline refinement.

For maps larger than a single device likes, the same observation table feeds
parallel/dist_ba.py (partition_ba_problem + a mesh).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.optim.ba import (
    BAProblem,
    adaptive_o_max,
    build_point_obs,
    bundle_adjustment,
    count_obs_drops,
)

O_MAX = 16
# cap: above 64 cams the Schur assembly takes the scatter path whose pair
# tensor is (L, O, O, 6, 6) — O=24 keeps it within ~1.4 GB at L=16384
O_CAP = 24


def _round_up(n: int, m: int) -> int:
    return -(-max(n, 1) // m) * m


def global_bundle_adjustment(
    smap,
    K: np.ndarray,
    inv_level_sigma2: np.ndarray,
    iterations: int = 15,
    fixed_kfs=(0,),
):
    """Optimize all valid keyframes + landmarks; writes back + scrubs.

    Returns (n_cams, n_points, n_obs) actually optimized.
    """
    n_kf = smap.n_kf
    valid_kf = smap.kf_valid_host()[:n_kf]
    cams = [int(k) for k in range(n_kf) if valid_kf[k]]
    if len(cams) < 2:
        return 0, 0, 0
    lm_ids = np.nonzero(smap.lm_valid_host())[0]
    if len(lm_ids) == 0:
        return 0, 0, 0
    kf_idx, feat_idx, which = smap.observations_of(lm_ids)
    keep = np.isin(kf_idx, cams)
    kf_idx, feat_idx, which = kf_idx[keep], feat_idx[keep], which[keep]
    cam_slot = {k: i for i, k in enumerate(cams)}
    obs_cam = np.array([cam_slot[int(k)] for k in kf_idx], np.int32)
    obs_uv = smap.hview("kf_xy")[kf_idx, feat_idx].astype(np.float32)
    obs_oct = smap.hview("kf_octave")[kf_idx, feat_idx]
    inv_s2 = inv_level_sigma2[np.clip(obs_oct, 0, len(inv_level_sigma2) - 1)]

    K_pad = _round_up(len(cams), 16)
    L_pad = _round_up(len(lm_ids), 1024)
    O_pad = _round_up(len(obs_cam), 4096)

    poses = np.tile(np.eye(4, dtype=np.float32), (K_pad, 1, 1))
    poses[: len(cams)] = smap.hview("kf_pose")[cams]
    points = np.zeros((L_pad, 3), np.float32)
    points[: len(lm_ids)] = smap.hview("lm_pos")[lm_ids]
    fixed = np.ones(K_pad, bool)
    for i, k in enumerate(cams):
        fixed[i] = k in fixed_kfs

    def pad(x, n, fill=0):
        out = np.full((n,) + x.shape[1:], fill, x.dtype)
        out[: len(x)] = x[:n]
        return out

    which32 = which.astype(np.int32)
    max_count = int(np.bincount(which32, minlength=1).max())
    o_max = adaptive_o_max(max_count, O_MAX, cap=O_CAP)
    dropped = count_obs_drops(which32, len(lm_ids), o_max)
    if dropped:
        import logging

        logging.getLogger("orbslam").warning(
            "global BA dropped %d observations beyond o_max=%d", dropped, o_max
        )
    prob = BAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(points),
        obs_cam=jnp.asarray(pad(obs_cam, O_pad)),
        obs_point=jnp.asarray(pad(which32, O_pad)),
        obs_uv=jnp.asarray(pad(obs_uv, O_pad)),
        obs_inv_sigma2=jnp.asarray(pad(inv_s2.astype(np.float32), O_pad, 1.0)),
        obs_mask=jnp.asarray(pad(np.ones(len(obs_cam), bool), O_pad, False)),
        point_obs=jnp.asarray(
            build_point_obs(pad(which32, O_pad, -1), L_pad, o_max)
        ),
        fixed_cam=jnp.asarray(fixed),
        K=jnp.asarray(K),
    )
    poses_new, points_new, chi2 = bundle_adjustment(prob, iterations=iterations)
    smap.set_kf_poses(cams, np.asarray(poses_new)[: len(cams)])
    smap.set_landmark_positions(lm_ids, np.asarray(points_new)[: len(lm_ids)])
    chi2_h = np.asarray(chi2)[: len(obs_cam)]
    bad = chi2_h > 5.991
    if bad.any():
        smap.scrub_observations(kf_idx[bad], feat_idx[bad])
    return len(cams), len(lm_ids), len(obs_cam)
