"""Frame: fixed-shape per-image feature container.

Replaces the reference's Frame (include/Frame.h, src/Frame.cpp): instead of
a 64x48 pointer grid (src/Frame.cpp:144-159) and per-keypoint vectors, a
Frame is a pytree of fixed-shape arrays (validity-masked). Windowed queries
(GetFeaturesInArea, src/Frame.cpp:219-271) are replaced by dense distance
masks in the matcher — no pointer chasing, matmul-friendly.

Poses live in the tracking state, not on the Frame (the reference's Frame
copy constructor dropped pose state anyway, src/Frame.cpp:13-38 — a defect).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Frame(NamedTuple):
    """All arrays have leading dim n_features (fixed budget, masked)."""

    xy: jnp.ndarray  # (N, 2) undistorted level-0 pixel coords
    xy_raw: jnp.ndarray  # (N, 2) raw (distorted) pixel coords
    octave: jnp.ndarray  # (N,) int32 pyramid level
    angle: jnp.ndarray  # (N,) float32 orientation (radians)
    response: jnp.ndarray  # (N,) float32 FAST score
    valid: jnp.ndarray  # (N,) bool
    desc_packed: jnp.ndarray  # (N, 8) uint32 BRIEF bits
    desc_pm1: jnp.ndarray  # (N, 256) int8 ±1 (matmul-ready)

    @property
    def n_features(self) -> int:
        return self.xy.shape[0]

    def num_valid(self):
        return jnp.sum(self.valid)
