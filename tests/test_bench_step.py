"""The benchmark's fused tracking step really tracks.

The step decodes its image input as 8.8 fixed-point uint16
(slam/tracking.encode_frame_u16); a bench that fed raw float pixels made it
see an image in [0, 1): no keypoints, a failed track, and a meaningless
frame rate.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _build_bench_state  # noqa: E402


def test_bench_state_tracks():
    fn, args, images = _build_bench_state(1)
    assert args[0].dtype == np.uint16
    frame, _, _, _, ok1, ok, n2 = fn(*args)
    assert int(np.asarray(frame.valid).sum()) > 400
    assert bool(ok1) and bool(ok)
    assert int(n2) >= 30
