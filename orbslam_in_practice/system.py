"""SlamSystem: the API facade.

Mirrors the reference's SlamSystem (include/system.h:14-23): construct from a
settings file (or SlamConfig), feed monocular frames, get poses back — plus
the pieces the reference lacked: shutdown/reset, trajectory export,
checkpointing (SURVEY.md §5).

The second constructor argument of the reference named a BoW vocabulary that
was never loaded (src/system.cpp:10); this engine needs no vocabulary —
descriptor retrieval is a dense matmul — so the argument is accepted and
ignored for drop-in compatibility.
"""

from __future__ import annotations

import numpy as np

from orbslam_in_practice.config import SlamConfig, load_config
from orbslam_in_practice.slam.tracking import Tracking, TrackingState


class SlamSystem:
    def __init__(self, config, bow_path: str | None = None):
        """config: path to an ORB-SLAM style YAML or a SlamConfig."""
        if isinstance(config, str):
            config = load_config(config)
        self.cfg: SlamConfig = config
        self.tracker = Tracking(config)

    def track_monocular(self, image, timestamp: float):
        """Feed one grayscale frame (H, W) [0, 255]; returns Tcw or None
        (ref Trackmonocular src/system.cpp:23-29)."""
        img = np.asarray(image, np.float32)
        if img.ndim == 3:  # RGB/BGR -> gray (ref track_mono :56-70)
            w = (
                np.array([0.299, 0.587, 0.114], np.float32)
                if self.cfg.rgb
                else np.array([0.114, 0.587, 0.299], np.float32)
            )
            img = img @ w
        return self.tracker.track_mono(img, timestamp)

    # alias matching the reference spelling (include/system.h:19)
    Trackmonocular = track_monocular

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    @property
    def map(self):
        return self.tracker.map

    def reset(self):
        self.tracker.reset()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until the async mapping worker has drained its queue
        (no-op in synchronous mode). Call before reading the map or
        trajectory mid-run for a settled view."""
        if self.tracker.async_driver is not None:
            return self.tracker.async_driver.drain(timeout)
        return True

    def shutdown(self):
        """Join the mapping worker (ORB-SLAM System::Shutdown semantics)."""
        if self.tracker.async_driver is not None:
            self.tracker.async_driver.shutdown()

    # ---------------- trajectory / persistence ----------------

    def get_trajectory(self):
        """[(frame_id, timestamp, Tcw 4x4 np or None), ...], re-anchored to
        the current (possibly BA/loop-refined) keyframe poses."""
        from orbslam_in_practice.slam.tracking import materialize_trajectory

        return materialize_trajectory(self.tracker)

    def save_trajectory_tum(self, path: str):
        from orbslam_in_practice.io.trajectory import save_tum

        save_tum(path, self.get_trajectory())

    def save_trajectory_kitti(self, path: str):
        from orbslam_in_practice.io.trajectory import save_kitti

        save_kitti(path, self.get_trajectory())

    def save_map(self, path: str):
        from orbslam_in_practice.utils.checkpoint import save_map

        self.wait_idle()
        save_map(path, self.tracker.map)

    def load_map(self, path: str):
        from orbslam_in_practice.utils.checkpoint import load_map

        load_map(path, self.tracker.map)
