"""FAST-9/16 corner scoring + 3x3 NMS, fully vectorized (elementwise).

Replaces the reference's per-cell cv::FAST loop
(src/ORBextractor.cpp:745-786) with a whole-image score map:

- The 16-pixel Bresenham circle is materialized as 16 shifted copies of the
  image (jnp.roll — pure data movement, fuses into the elementwise pipeline).
- The OpenCV FAST *score* (max threshold at which the pixel is still a
  corner) is computed in closed form: for each of the 16 window positions,
  the min margin over 9 contiguous circle pixels; score = max over windows,
  for both the brighter and darker polarity. A pixel is a corner at
  threshold t iff score > t — so ONE score map serves both the high
  (iniThFAST) and fallback (minThFAST) thresholds of the reference.
- 3x3 non-max suppression via reduce_window.

This design has no data-dependent shapes: downstream selection takes top-k
of the masked score map.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

# OpenCV FAST-16 circle offsets (x, y), circular order, radius 3.
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

_ARC = 9  # contiguous arc length for FAST-9


def fast_score(img: jnp.ndarray) -> jnp.ndarray:
    """FAST-9/16 corner score map. img (H, W) float32 -> (H, W) float32.

    score > t  <=>  pixel is a FAST corner at threshold t.
    A 3px border is zeroed (the circle would wrap).
    """
    h, w = img.shape
    # 16 circle neighbors via roll: neighbor value at (y+dy, x+dx).
    neigh = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for (dx, dy) in _CIRCLE],
        axis=0,
    )  # (16, H, W)
    m = neigh - img[None]  # margin for "brighter" arc; "darker" is -m

    # circular window-min of length 9 via a doubling tree (4 combines
    # instead of 8): min9(k) = min(min8(k), m(k+8)); min over the darker
    # polarity = -max over the same windows, so one tree per op serves
    # both polarities.
    def win9(x, op):
        x2 = op(x, jnp.roll(x, -1, axis=0))
        x4 = op(x2, jnp.roll(x2, -2, axis=0))
        x8 = op(x4, jnp.roll(x4, -4, axis=0))
        return op(x8, jnp.roll(x, -8, axis=0))

    bright = jnp.max(win9(m, jnp.minimum), axis=0)
    dark = -jnp.min(win9(m, jnp.maximum), axis=0)
    score = jnp.maximum(bright, dark)
    score = jnp.maximum(score, 0.0)
    # zero the 3px border
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(interior, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep strict local maxima of a 3x3 neighborhood (ties broken toward the
    top-left via epsilon on the pooled comparison)."""
    pooled = lax.reduce_window(
        score, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= pooled, score, 0.0)


def fast_corners_np(img: np.ndarray, threshold: float) -> np.ndarray:
    """Slow numpy golden model (for parity tests): boolean corner mask."""
    h, w = img.shape
    out = np.zeros((h, w), dtype=bool)
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            c = img[y, x]
            vals = np.array([img[y + dy, x + dx] for (dx, dy) in _CIRCLE])
            for margin in (vals - c, c - vals):
                m = margin > threshold
                mm = np.concatenate([m, m])
                run, best = 0, 0
                for v in mm:
                    run = run + 1 if v else 0
                    best = max(best, run)
                if best >= _ARC:
                    out[y, x] = True
    return out
