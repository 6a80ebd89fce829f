"""ORBExtractor: the full multi-scale ORB pipeline as one jitted function.

Fixed-shape redesign of the reference's ORBextractor
(src/ORBextractor.cpp:1001-1065 operator() and its callees, SURVEY.md §3.2):
per level — FAST score map -> NMS -> grid-uniform top-k -> IC orientation ->
Gaussian blur -> rotated BRIEF. All shapes static (per-level budgets);
keypoint coordinates are scaled to level 0 and undistorted in-graph.

The whole extractor compiles to a single XLA program per image size; the
Python level loop unrolls at trace time.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.frontend.frame import Frame
from orbslam_in_practice.geometry.camera import CameraIntrinsics, undistort_points
from orbslam_in_practice.ops.fast import fast_score, nms3x3
from orbslam_in_practice.ops.hamming import unpack_to_pm1
from orbslam_in_practice.ops.image import build_pyramid, gaussian_blur7
from orbslam_in_practice.ops.orb import (
    brief_descriptors,
    ic_angle,
    level_budgets,
    select_keypoints,
)


class ORBExtractor:
    """Configured like the reference ctor (src/ORBextractor.cpp:360-420):
    (nFeatures, scaleFactor, nLevels, iniThFAST, minThFAST)."""

    def __init__(
        self,
        n_features: int = 1000,
        scale_factor: float = 1.2,
        n_levels: int = 8,
        ini_th_fast: float = 20.0,
        min_th_fast: float = 7.0,
        cam: CameraIntrinsics | None = None,
    ):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = ini_th_fast
        self.min_th = min_th_fast
        self.cam = cam
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        self.total = sum(self.budgets)
        # per-octave scale^2 (information weights for BA, fixing the
        # reference's uninitialized invSigma2, src/Optimizer.cpp:96-97)
        self.level_sigma2 = np.array(
            [(scale_factor**i) ** 2 for i in range(n_levels)], dtype=np.float32
        )
        self.inv_level_sigma2 = (1.0 / self.level_sigma2).astype(np.float32)
        self._jit_cache = {}

    def __call__(self, image: jnp.ndarray) -> Frame:
        """image: (H, W) float32 grayscale in [0, 255] -> Frame."""
        shape = tuple(image.shape)
        if shape not in self._jit_cache:
            self._jit_cache[shape] = jax.jit(self._extract)
        return self._jit_cache[shape](image)

    def _extract(self, image: jnp.ndarray) -> Frame:
        # named scopes label each stage's kernels in a profiler trace
        # (tools/profile_stages.py reads them)
        with jax.named_scope("orb_pyramid"):
            levels = build_pyramid(image, self.n_levels, self.scale_factor)
        xs, raws, octs, angs, resps, valids, descs = [], [], [], [], [], [], []
        for lvl, img_l in enumerate(levels):
            budget = self.budgets[lvl]
            if budget <= 0:
                continue
            with jax.named_scope(f"orb_L{lvl}_fast_nms"):
                score = nms3x3(fast_score(img_l))
            with jax.named_scope(f"orb_L{lvl}_select"):
                yx, resp, valid = select_keypoints(
                    score, budget, self.ini_th, self.min_th
                )
            with jax.named_scope(f"orb_L{lvl}_angle"):
                ang = ic_angle(img_l, yx)
            with jax.named_scope(f"orb_L{lvl}_blur"):
                blur = gaussian_blur7(img_l)
            with jax.named_scope(f"orb_L{lvl}_brief"):
                desc = brief_descriptors(blur, yx, ang)
            s = self.scale_factor**lvl
            xy_raw = jnp.stack([yx[:, 1].astype(jnp.float32), yx[:, 0].astype(jnp.float32)], -1) * s
            xs.append(xy_raw)
            raws.append(xy_raw)
            octs.append(jnp.full((budget,), lvl, dtype=jnp.int32))
            angs.append(ang)
            resps.append(resp)
            valids.append(valid)
            descs.append(desc)
        xy_raw = jnp.concatenate(raws, axis=0)
        octave = jnp.concatenate(octs, axis=0)
        angle = jnp.concatenate(angs, axis=0)
        response = jnp.concatenate(resps, axis=0)
        valid = jnp.concatenate(valids, axis=0)
        desc_packed = jnp.concatenate(descs, axis=0)

        if self.cam is not None and self.cam.has_distortion:
            K = self.cam.K
            dist = jnp.asarray(self.cam.dist, dtype=jnp.float32)
            xy = undistort_points(K, dist, xy_raw)
        else:
            xy = xy_raw
        return Frame(
            xy=xy,
            xy_raw=xy_raw,
            octave=octave,
            angle=angle,
            response=response,
            valid=valid,
            desc_packed=desc_packed,
            desc_pm1=unpack_to_pm1(desc_packed),
        )
