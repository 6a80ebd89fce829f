"""ORB keypoint selection, orientation, and rotated-BRIEF descriptors.

Fixed-shape replacements for the reference's hot loops
(SURVEY.md §3.2 call stack):

- Spatial distribution: the pointer-chasing quadtree DistributeOctTree
  (src/ORBextractor.cpp:489-718) becomes a fixed-shape grid-bucketed
  "round-robin by in-cell rank" top-k: every cell contributes its best
  keypoint before any cell contributes its second — the same spatial
  uniformity contract, with static shapes.
- Threshold fallback: the per-cell iniThFAST -> minThFAST retry (:745-786)
  becomes a mask: low-threshold corners are eligible only in cells that have
  no high-threshold corner.
- Orientation: IC_Angle intensity centroid (:27-54) as a masked 31x31 patch
  reduction over gathered patches.
- Descriptors: computeOrbDescriptor (:58-97) as a batched gather of the 256
  canonical pattern pairs, rotated per-keypoint, compared and bit-packed.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.ops.hamming import pack_bits
from orbslam_in_practice.ops.orb_pattern import ORB_PATTERN

PATCH_R = 15  # IC-angle patch radius (31x31), ref :27-54
DESC_R = 19  # descriptor gather radius (rotated pattern reach), ref EDGE_THRESHOLD
BORDER = 19  # keypoint exclusion border


def _circle_mask_31() -> np.ndarray:
    dy, dx = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    return (dx * dx + dy * dy <= PATCH_R * PATCH_R).astype(np.float32)


_CIRCLE31 = _circle_mask_31()
_DX31 = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1][1].astype(np.float32)
_DY31 = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1][0].astype(np.float32)


def select_keypoints(
    score: jnp.ndarray,
    budget: int,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    cell: int = 32,
    border: int = BORDER,
):
    """Grid-uniform top-k keypoint selection from an NMS'd score map.

    Returns (yx (budget, 2) int32, response (budget,) f32, valid (budget,)).
    """
    h, w = score.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = jnp.where(interior, score, 0.0)

    # pad to cell multiples
    hp = (h + cell - 1) // cell * cell
    wp = (w + cell - 1) // cell * cell
    sp = jnp.pad(score, ((0, hp - h), (0, wp - w)))
    hc, wc = hp // cell, wp // cell
    cells = sp.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(hc * wc, cell * cell)

    # threshold fallback: low-threshold corners allowed only in cells with no
    # high-threshold corner (ref :745-786 semantics)
    cell_max = jnp.max(cells, axis=-1, keepdims=True)
    has_ini = cell_max > ini_th
    eligible = jnp.where(
        cells > ini_th, cells, jnp.where((cells > min_th) & (~has_ini), cells, 0.0)
    )

    # per-cell top-m
    n_cells = hc * wc
    m = max(1, min(cell * cell, -(-2 * budget // n_cells) + 2))
    vals, idx_in_cell = jax.lax.top_k(eligible, m)  # (n_cells, m)

    # round-robin by in-cell rank: all rank-0 first (by score), then rank-1...
    rank = jnp.broadcast_to(jnp.arange(m)[None, :], vals.shape).astype(jnp.float32)
    key = jnp.where(vals > 0.0, rank * 1e6 - vals, jnp.inf)
    flat_key = key.reshape(-1)
    neg = -flat_key  # top_k takes largest; we want smallest key
    take_vals, take_idx = jax.lax.top_k(jnp.where(jnp.isfinite(neg), neg, -jnp.inf), budget)
    valid = jnp.isfinite(take_vals) & (take_vals > -jnp.inf)

    cell_id = take_idx // m
    kth = take_idx % m
    in_cell = idx_in_cell[cell_id, kth]
    cy, cx = cell_id // wc, cell_id % wc
    y = cy * cell + in_cell // cell
    x = cx * cell + in_cell % cell
    response = vals[cell_id, kth]
    valid = valid & (response > 0.0) & (y < h) & (x < w)
    yx = jnp.stack([y, x], axis=-1).astype(jnp.int32)
    yx = jnp.where(valid[:, None], yx, 0)
    return yx, jnp.where(valid, response, 0.0), valid


def _gather_patches(img: jnp.ndarray, yx: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(H, W), (N, 2) int -> (N, 2r+1, 2r+1) patches (clamped at borders)."""
    size = 2 * radius + 1
    h, w = img.shape

    def one(p):
        y0 = jnp.clip(p[0] - radius, 0, h - size)
        x0 = jnp.clip(p[1] - radius, 0, w - size)
        return jax.lax.dynamic_slice(img, (y0, x0), (size, size))

    return jax.vmap(one)(yx)


def ic_angle(img: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation (radians) per keypoint (ref :27-54)."""
    patches = _gather_patches(img, yx, PATCH_R)  # (N, 31, 31)
    mask = jnp.asarray(_CIRCLE31)
    m10 = jnp.sum(patches * (jnp.asarray(_DX31) * mask), axis=(-1, -2))
    m01 = jnp.sum(patches * (jnp.asarray(_DY31) * mask), axis=(-1, -2))
    return jnp.arctan2(m01, m10)


def brief_descriptors(
    img_blur: jnp.ndarray, yx: jnp.ndarray, angle: jnp.ndarray
) -> jnp.ndarray:
    """Rotated-BRIEF 256-bit descriptors, packed (N, 8) uint32 (ref :58-97).

    Pattern points are rotated by the keypoint angle and rounded to the
    nearest pixel (the reference's cvRound), then compared pairwise:
    bit k = I(p_a) < I(p_b).
    """
    size = 2 * DESC_R + 1
    patches = _gather_patches(img_blur, yx, DESC_R)  # (N, 39, 39)
    flat = patches.reshape(patches.shape[0], -1)  # (N, 39*39)

    pat = jnp.asarray(ORB_PATTERN, dtype=jnp.float32)  # (256, 2, 2) [(x, y)]
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (N,)
    px = pat[None, :, :, 0]  # (1, 256, 2)
    py = pat[None, :, :, 1]
    rx = jnp.round(px * ca[:, None, None] - py * sa[:, None, None]).astype(jnp.int32)
    ry = jnp.round(px * sa[:, None, None] + py * ca[:, None, None]).astype(jnp.int32)
    rx = jnp.clip(rx, -DESC_R, DESC_R)
    ry = jnp.clip(ry, -DESC_R, DESC_R)
    idx = (ry + DESC_R) * size + (rx + DESC_R)  # (N, 256, 2)
    vals = jnp.take_along_axis(flat[:, None, :], idx.reshape(idx.shape[0], -1)[:, None, :], axis=-1)
    vals = vals.reshape(idx.shape[0], 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)  # (N, 256)
    return pack_bits(bits)


def level_budgets(n_features: int, n_levels: int, scale: float) -> list:
    """Per-level feature budgets ∝ (1/scale)^level (ref ctor :360-420)."""
    inv = 1.0 / scale
    factors = np.array([inv**i for i in range(n_levels)])
    raw = n_features * factors / factors.sum()
    budgets = [int(round(x)) for x in raw]
    budgets[-1] = max(1, n_features - sum(budgets[:-1]))
    return budgets
