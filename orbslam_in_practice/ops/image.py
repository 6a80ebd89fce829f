"""Image pyramid + separable Gaussian blur (jnp / XLA).

Replaces cv::resize / cv::GaussianBlur in the reference's ComputePyramid and
descriptor pre-blur (src/ORBextractor.cpp:1071-1096, :1046). Static per-level
shapes are computed in Python at trace time so the whole pyramid compiles to
fixed-shape XLA ops (bilinear resize + two 1-D convolutions — both fuse well
and stream HBM once).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@lru_cache(maxsize=None)
def _gauss_kernel7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(7, dtype=np.float64) - 3.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur7(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """7x7 separable Gaussian, REPLICATE borders (matches cv BORDER_REFLECT
    closely enough for descriptor sampling). img: (H, W) float32.

    Implemented as 7+7 statically-shifted weighted adds rather than
    lax.conv: XLA fuses the shifts into two elementwise passes, and —
    unlike a convolution, which at default precision XLA:GPU may run in
    TF32 (~1e-3 relative error on [0,255] pixels, enough to flip BRIEF
    comparison bits) — this stays exact float32 whatever the precision
    setting.
    """
    k = _gauss_kernel7(sigma)
    h, w = img.shape
    x = jnp.pad(img, ((3, 3), (0, 0)), mode="edge")
    y = sum(k[i] * x[i : i + h, :] for i in range(7))
    y = jnp.pad(y, ((0, 0), (3, 3)), mode="edge")
    return sum(k[j] * y[:, j : j + w] for j in range(7))


def build_pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static (h, w) per level, floor-scaled like the reference (:1071-1096)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale**lvl)
        shapes.append((max(int(round(height * inv)), 32), max(int(round(width * inv)), 32)))
    return shapes


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float):
    """Bilinear pyramid; returns list of (h_l, w_l) float32 arrays."""
    h, w = img.shape
    shapes = build_pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(
            jax.image.resize(img, shapes[lvl], method="bilinear", antialias=False)
        )
    return levels
