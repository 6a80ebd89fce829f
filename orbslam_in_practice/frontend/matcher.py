"""Descriptor matching: dense masked Hamming with ORB-SLAM's gating rules.

Replaces the reference's ORBmatcher (src/ORBmatcher.cpp) and the stubbed
SearchByProjection/SearchByBoW (include/ORBmatcher.h:22-24, empty bodies —
SURVEY.md §2.4) with real implementations:

- search_for_initialization: windowed brute force + ratio test +
  cross-consistency + rotation-histogram filtering (ref :9-126).
- search_by_projection: project map points into the frame, search a
  per-point radius window with octave gating (implements the semantics the
  reference declared but left empty; contract from original ORB-SLAM).

The N x M Hamming matrix is ONE int8 matmul (ops/hamming.py); all window
and level gates are masks on that matrix. Unique assignment is resolved by
a scatter-min over claimed features.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from orbslam_in_practice.frontend.frame import Frame
from orbslam_in_practice.ops.hamming import hamming_matrix

TH_LOW = 50  # ref src/ORBmatcher.cpp:7
TH_HIGH = 100  # original ORB-SLAM TH_HIGH
HISTO_BINS = 30  # ref :6
_BIG = 1 << 20  # plain int: no backend init at import time


def _rotation_consistency(rot_diff: jnp.ndarray, matched: jnp.ndarray) -> jnp.ndarray:
    """Keep matches whose angle difference falls in the top-3 histogram bins
    (ref ComputeThreeMaxima :147-188; also drops bins < 0.1 * max)."""
    two_pi = 2.0 * jnp.pi
    frac = jnp.mod(rot_diff, two_pi) / two_pi
    bins = jnp.clip((frac * HISTO_BINS).astype(jnp.int32), 0, HISTO_BINS - 1)
    hist = jnp.zeros(HISTO_BINS, jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[0]
    keep_bin = (hist[:, None] == top3[None, :]).any(axis=-1) & (
        hist > 0.1 * top3[0]
    )
    return matched & keep_bin[bins]


@partial(jax.jit, static_argnames=("window", "check_rotation"))
def search_for_initialization(
    f1: Frame,
    f2: Frame,
    prev_xy: jnp.ndarray | None = None,
    window: int = 100,
    nn_ratio: float = 0.9,
    check_rotation: bool = True,
):
    """Level-0 windowed matching for monocular init (ref :9-126).

    Args:
      f1, f2: Frames. prev_xy: (N1, 2) search centers in f2 (defaults to
        f1.xy — the reference seeds with the first frame's keypoints,
        src/Tracking.cpp:181-189).

    Returns:
      matches12: (N1,) int32 index into f2 (-1 = unmatched).
    """
    if prev_xy is None:
        prev_xy = f1.xy
    dist = hamming_matrix(f1.desc_pm1, f2.desc_pm1)  # (N1, N2)
    lvl0 = (f1.octave == 0)[:, None] & (f2.octave == 0)[None, :]
    validm = f1.valid[:, None] & f2.valid[None, :]
    dx = jnp.abs(prev_xy[:, 0:1] - f2.xy[None, :, 0])
    dy = jnp.abs(prev_xy[:, 1:2] - f2.xy[None, :, 1])
    in_win = (dx <= window) & (dy <= window)
    masked = jnp.where(validm & lvl0 & in_win, dist, _BIG)

    # best two in f2 for each f1 keypoint
    neg_top2, idx_top2 = jax.lax.top_k(-masked, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    j_best = idx_top2[:, 0]
    ok = (d1 <= TH_LOW) & (d1.astype(jnp.float32) < nn_ratio * d2.astype(jnp.float32))

    # cross-consistency: f1 row must be the best for its claimed f2 column
    best_for_col = jnp.argmin(masked, axis=0)  # (N2,)
    rows = jnp.arange(f1.n_features)
    ok = ok & (best_for_col[j_best] == rows)

    if check_rotation:
        rot = f1.angle - f2.angle[j_best]
        ok = _rotation_consistency(rot, ok)
    return jnp.where(ok, j_best, -1)


@partial(jax.jit, static_argnames=("max_th_dist", "use_ratio"))
def search_by_projection(
    pts_w: jnp.ndarray,
    pts_desc_pm1: jnp.ndarray,
    pts_valid: jnp.ndarray,
    pts_octave: jnp.ndarray,
    Tcw: jnp.ndarray,
    frame: Frame,
    K: jnp.ndarray,
    radius: jnp.ndarray,
    scale_factors: jnp.ndarray,
    max_th_dist: int = TH_HIGH,
    use_ratio: bool = False,
    nn_ratio: float = 0.9,
    pts_normal: jnp.ndarray | None = None,
    pts_min_dist: jnp.ndarray | None = None,
    pts_max_dist: jnp.ndarray | None = None,
):
    """Project world points into the frame, match in a radius window.

    Implements the contract of ORB-SLAM's SearchByProjection (stubbed empty
    in the reference, include/ORBmatcher.h:24) + the isInFrustum gating the
    reference's Frame couldn't perform (src/Frame.cpp:194-195 read
    uninitialized min/max view distances — SURVEY.md §2.4): per point,
    require positive depth, image bounds, distance within
    [0.8 min, 1.2 max], viewing-angle cosine > 0.5 against the landmark
    normal, then search features within radius * scale_factor[predicted
    octave] pixels whose octave matches the DISTANCE-PREDICTED scale
    (ORB-SLAM's PredictScale) within ±1, pick min Hamming.

    Args:
      pts_w: (M, 3) world positions; pts_desc_pm1: (M, 256) representative
      descriptors; pts_valid: (M,); pts_octave: (M,) reference octave
      (fallback when distance invariants are not given); Tcw: (4, 4);
      radius: scalar or (M,) base search radius in pixels; optional
      pts_normal (M, 3), pts_min_dist / pts_max_dist (M,).

    Returns:
      (matches: (M,) int32 feature index or -1,
       proj_uv: (M, 2) projected pixel coords,
       in_image: (M,) bool frustum test result)
    """
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = K[0, 0] * pc[:, 0] / z_safe + K[0, 2]
    v = K[1, 1] * pc[:, 1] / z_safe + K[1, 2]
    proj = jnp.stack([u, v], axis=-1)

    # image-bound check against the frame's observed keypoint extents
    min_x = jnp.min(jnp.where(frame.valid, frame.xy[:, 0], jnp.inf))
    max_x = jnp.max(jnp.where(frame.valid, frame.xy[:, 0], -jnp.inf))
    min_y = jnp.min(jnp.where(frame.valid, frame.xy[:, 1], jnp.inf))
    max_y = jnp.max(jnp.where(frame.valid, frame.xy[:, 1], -jnp.inf))
    in_image = (z > 0.0) & (u >= min_x) & (u <= max_x) & (v >= min_y) & (v <= max_y)

    # frustum gating via landmark invariants (isInFrustum semantics)
    cam_center = -R.T @ t
    po = pts_w - cam_center
    d = jnp.linalg.norm(po, axis=-1)
    pred_octave = pts_octave
    if pts_min_dist is not None and pts_max_dist is not None:
        dist_ok = (d >= 0.8 * pts_min_dist) & (d <= 1.2 * pts_max_dist)
        in_image = in_image & dist_ok
        # PredictScale: level such that max_dist / scale^level ~ d
        n_levels = scale_factors.shape[0]
        log_scale = jnp.log(scale_factors[1] / scale_factors[0])
        ratio = jnp.maximum(pts_max_dist, 1e-9) / jnp.maximum(d, 1e-9)
        pred_octave = jnp.clip(
            jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / log_scale).astype(jnp.int32),
            0,
            n_levels - 1,
        )
    if pts_normal is not None:
        view_cos = jnp.sum(po * pts_normal, axis=-1) / jnp.maximum(d, 1e-9)
        in_image = in_image & (view_cos > 0.5)

    dist = hamming_matrix(pts_desc_pm1, frame.desc_pm1)  # (M, N)
    r_scaled = jnp.broadcast_to(
        jnp.asarray(radius, jnp.float32), pts_valid.shape
    ) * scale_factors[jnp.clip(pred_octave, 0, scale_factors.shape[0] - 1)]
    du = jnp.abs(proj[:, 0:1] - frame.xy[None, :, 0])
    dv = jnp.abs(proj[:, 1:2] - frame.xy[None, :, 1])
    in_win = (du <= r_scaled[:, None]) & (dv <= r_scaled[:, None])
    oct_ok = jnp.abs(frame.octave[None, :] - pred_octave[:, None]) <= 1
    maskm = (
        pts_valid[:, None]
        & in_image[:, None]
        & frame.valid[None, :]
        & in_win
        & oct_ok
    )
    masked = jnp.where(maskm, dist, _BIG)

    neg_top2, idx_top2 = jax.lax.top_k(-masked, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    j_best = idx_top2[:, 0]
    ok = d1 <= max_th_dist
    if use_ratio:
        ok = ok & (d1.astype(jnp.float32) < nn_ratio * d2.astype(jnp.float32))

    # unique assignment: if several points claim one feature keep min distance
    claim = jnp.full(frame.n_features, _BIG, jnp.int32).at[j_best].min(
        jnp.where(ok, d1, _BIG)
    )
    ok = ok & (claim[j_best] == d1)
    # among equal-distance claimants keep the lowest point index
    first = jnp.full(frame.n_features, jnp.int32(1 << 30)).at[j_best].min(
        jnp.where(ok, jnp.arange(pts_valid.shape[0], dtype=jnp.int32), jnp.int32(1 << 30))
    )
    ok = ok & (first[j_best] == jnp.arange(pts_valid.shape[0], dtype=jnp.int32))
    return jnp.where(ok, j_best, -1), proj, in_image


@partial(jax.jit, static_argnames=("check_rotation",))
def search_frame_to_kf(
    frame: Frame,
    kf_xy: jnp.ndarray,
    kf_angle: jnp.ndarray,
    kf_desc_pm1: jnp.ndarray,
    kf_has_lm: jnp.ndarray,
    nn_ratio: float = 0.7,
    check_rotation: bool = True,
):
    """Match current-frame features against a keyframe's landmark-bearing
    features (the role of the reference's stubbed SearchByBoW,
    include/ORBmatcher.h:22 — the BoW acceleration is unnecessary on an
    accelerator: the full Hamming matrix is one int8 matmul).

    Returns matches: (N_frame,) int32 index into KF features (-1 unmatched).
    """
    dist = hamming_matrix(frame.desc_pm1, kf_desc_pm1)  # (N, F_kf)
    maskm = frame.valid[:, None] & kf_has_lm[None, :]
    masked = jnp.where(maskm, dist, _BIG)
    neg_top2, idx_top2 = jax.lax.top_k(-masked, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    j_best = idx_top2[:, 0]
    ok = (d1 <= TH_LOW) & (d1.astype(jnp.float32) < nn_ratio * d2.astype(jnp.float32))
    # cross-check
    best_for_col = jnp.argmin(masked, axis=0)
    rows = jnp.arange(frame.n_features)
    ok = ok & (best_for_col[j_best] == rows)
    if check_rotation:
        rot = frame.angle - kf_angle[j_best]
        ok = _rotation_consistency(rot, ok)
    return jnp.where(ok, j_best, -1)


@jax.jit
def epipolar_match_kf(
    xy1: jnp.ndarray,
    desc1_pm1: jnp.ndarray,
    free1: jnp.ndarray,
    octave1: jnp.ndarray,
    xy2: jnp.ndarray,
    desc2_pm1: jnp.ndarray,
    free2: jnp.ndarray,
    octave2: jnp.ndarray,
    F12: jnp.ndarray,
    inv_level_sigma2: jnp.ndarray,
    max_dist: jnp.ndarray | int = TH_HIGH,
    angle1: jnp.ndarray | None = None,
    angle2: jnp.ndarray | None = None,
):
    """Epipolar-constrained matching of two keyframes' UNMATCHED features,
    for new-map-point triangulation (the LocalMapping capability the
    reference left absent — SURVEY.md §2.1 #13 'new-point triangulation').

    Args:
      xy1/xy2: (F, 2) undistorted coords; desc*_pm1: (F, 256); free*: (F,)
      bool (valid feature with NO landmark); F12: fundamental matrix with
      x2' F12 x1 = 0; inv_level_sigma2: per-octave information.

    Returns matches: (F1,) int32 index into KF2 features (-1 unmatched).
    """
    dist = hamming_matrix(desc1_pm1, desc2_pm1)  # (F1, F2)
    ones1 = jnp.ones_like(xy1[:, :1])
    h1 = jnp.concatenate([xy1, ones1], axis=-1)  # (F1, 3)
    # epipolar line of each x1 in image 2: l2 = F12 h1
    l2 = h1 @ F12.T  # (F1, 3)
    num = l2[:, None, 0] * xy2[None, :, 0] + l2[:, None, 1] * xy2[None, :, 1] + l2[:, None, 2:3][..., 0]
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2
    d2_line = num * num / jnp.maximum(den[:, None], 1e-12)  # (F1, F2)
    sig2 = 1.0 / inv_level_sigma2[jnp.clip(octave2, 0, inv_level_sigma2.shape[0] - 1)]
    epi_ok = d2_line < 3.84 * sig2[None, :]
    oct_ok = jnp.abs(octave1[:, None] - octave2[None, :]) <= 1
    maskm = free1[:, None] & free2[None, :] & epi_ok & oct_ok
    masked = jnp.where(maskm, dist, _BIG)
    d1 = jnp.min(masked, axis=1)
    j_best = jnp.argmin(masked, axis=1)
    # max_dist is caller-chosen: TH_HIGH when the keyframe pair has healthy
    # baseline/depth ratio (true correspondences carry Hamming ~40-90 under
    # realistic noise, and the epipolar constraint is informative), TH_LOW
    # when the pair is rotation-dominant (degenerate epipolar geometry lets
    # Hamming-50..100 mismatches through every later gate — measured 15x
    # ATE damage). A 0.9 ratio test keeps ambiguous texture out either way.
    d2 = jnp.sort(masked, axis=1)[:, 1]
    ok = (d1 <= jnp.asarray(max_dist)) & (
        d1.astype(jnp.float32) < 0.9 * d2.astype(jnp.float32)
    )
    # mutual best
    best_for_col = jnp.argmin(masked, axis=0)
    rows = jnp.arange(xy1.shape[0])
    ok = ok & (best_for_col[j_best] == rows)
    # rotation-histogram consistency (ORB-SLAM's SearchForTriangulation
    # applies mbCheckOrientation here too): mismatches on repeating texture
    # carry random relative angles and fall outside the top-3 bins. Only
    # applied when the histogram has statistical support — with few matches
    # the top-3-bin rule prunes GOOD matches near-randomly and biases the
    # spatial distribution of new landmarks (measured: 4x orbit drift).
    if angle1 is not None and angle2 is not None:
        filtered = _rotation_consistency(angle1 - angle2[j_best], ok)
        ok = jnp.where(jnp.sum(ok) >= 50, filtered, ok)
    return jnp.where(ok, j_best, -1)


def fundamental_from_poses(T1w: jnp.ndarray, T2w: jnp.ndarray, K: jnp.ndarray):
    """F12 such that x2' F12 x1 = 0, from world->cam poses (for
    epipolar_match_kf). Relative pose: T21 = T2w @ inv(T1w)."""
    R1 = T1w[:3, :3]
    t1 = T1w[:3, 3]
    R2 = T2w[:3, :3]
    t2 = T2w[:3, 3]
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1
    tx = jnp.array(
        [
            [0.0, -t21[2], t21[1]],
            [t21[2], 0.0, -t21[0]],
            [-t21[1], t21[0], 0.0],
        ],
        dtype=T1w.dtype,
    )
    Kinv = jnp.linalg.inv(K)
    return Kinv.T @ tx @ R21 @ Kinv


@partial(jax.jit, static_argnames=("check_rotation",))
def match_descriptor_sets(
    desc_a_pm1: jnp.ndarray,
    mask_a: jnp.ndarray,
    desc_b_pm1: jnp.ndarray,
    mask_b: jnp.ndarray,
    angle_a: jnp.ndarray | None = None,
    angle_b: jnp.ndarray | None = None,
    nn_ratio: float = 0.75,
    max_dist: int = TH_LOW,
    check_rotation: bool = False,
):
    """Generic masked descriptor-set matching (ratio + cross-check).

    Used for keyframe-to-keyframe association in loop closing (the BoW-based
    SearchByBoW role, stubbed in the reference include/ORBmatcher.h:22).
    Returns matches: (A,) int32 index into B (-1 unmatched).
    """
    dist = hamming_matrix(desc_a_pm1, desc_b_pm1)
    maskm = mask_a[:, None] & mask_b[None, :]
    masked = jnp.where(maskm, dist, _BIG)
    neg_top2, idx_top2 = jax.lax.top_k(-masked, 2)
    d1, d2 = -neg_top2[:, 0], -neg_top2[:, 1]
    j_best = idx_top2[:, 0]
    ok = (d1 <= max_dist) & (d1.astype(jnp.float32) < nn_ratio * d2.astype(jnp.float32))
    best_for_col = jnp.argmin(masked, axis=0)
    rows = jnp.arange(desc_a_pm1.shape[0])
    ok = ok & (best_for_col[j_best] == rows)
    if check_rotation and angle_a is not None:
        rot = angle_a - angle_b[j_best]
        ok = _rotation_consistency(rot, ok)
    return jnp.where(ok, j_best, -1)
