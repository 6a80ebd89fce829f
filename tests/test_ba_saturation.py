"""Local-BA behavior at observation-budget saturation (VERDICT r3 weak #3).

Mature maps exceed any fixed observation budget; the failure mode being
guarded: silent truncation in table-scan order exactly when the map matures.
Contract under test:
  1. Budgets GROW (power-of-2 buckets) up to the hard cap before anything is
     dropped — a window larger than the floor bucket but under the cap loses
     nothing.
  2. At the hard cap, the survivors are selected by observation strength
     (window cameras first, then covisibility with the current KF), never by
     scan order — and BA still converges on what remains.

Reference: g2o never drops edges (/root/reference/src/Optimizer.cpp:64-122);
the fixed-shape formulation must earn that semantics via adaptivity.
"""

import jax.numpy as jnp
import numpy as np

import orbslam_in_practice.slam.local_mapping as lm_mod
from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.slam.local_mapping import LocalMapper
from orbslam_in_practice.slam.map import SlamMap

N_FEAT = 64
N_LM = 40
N_KF = 6


class FakeFrame:
    def __init__(self, n, xy, valid, desc):
        self.n_features = n
        self.xy = jnp.asarray(xy)
        self.octave = jnp.zeros(n, jnp.int32)
        self.angle = jnp.zeros(n, jnp.float32)
        self.response = jnp.zeros(n, jnp.float32)
        self.valid = jnp.asarray(valid)
        self.desc_pm1 = jnp.asarray(desc)


def _build_saturated_map(rng, noise=0.05):
    """N_KF keyframes all observing N_LM landmarks (dense covisibility)."""
    smap = SlamMap(k_max=8, l_max=256, f_max=N_FEAT)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = np.stack(
        [
            rng.uniform(-2, 2, N_LM),
            rng.uniform(-1.5, 1.5, N_LM),
            rng.uniform(4, 8, N_LM),
        ],
        axis=1,
    ).astype(np.float32)
    ids = smap.allocate_landmarks(N_LM)
    smap.add_landmarks(
        ids, X + rng.normal(0, noise, X.shape).astype(np.float32),
        (rng.integers(0, 2, (N_LM, 256)).astype(np.int8) * 2 - 1),
        np.zeros((N_LM, 3), np.float32), np.zeros(N_LM, np.int32),
        np.zeros(N_LM, np.float32), np.full(N_LM, np.inf, np.float32),
        first_kf=0,
    )
    for k in range(N_KF):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * k, 0.02 * k, 0.0]
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = (pc @ K.T)
        uv = uv[:, :2] / uv[:, 2:3]
        xy = np.zeros((N_FEAT, 2), np.float32)
        xy[:N_LM] = uv + rng.normal(0, 0.3, uv.shape)
        obs = np.full(N_FEAT, -1, np.int32)
        obs[:N_LM] = ids
        desc = rng.integers(0, 2, (N_FEAT, 256)).astype(np.int8) * 2 - 1
        f = FakeFrame(N_FEAT, xy, np.ones(N_FEAT, bool), desc)
        smap.add_keyframe(f, jnp.asarray(T), obs, k)
    return smap, X, ids, K


def _cfg(**kw):
    return SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=N_FEAT, n_levels=4, local_window=4, **kw,
    )


def _reproj_rmse(smap, ids, K):
    X = smap.hview("lm_pos")[ids]
    errs = []
    for k in range(N_KF):
        T = smap.hview("kf_pose")[k]
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = pc @ np.asarray(K).T
        uv = uv[:, :2] / uv[:, 2:3]
        errs.append(np.linalg.norm(uv - smap.hview("kf_xy")[k][: len(ids)], axis=1))
    return float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))


def test_budget_grows_before_dropping(rng):
    """240 observations against a 64-obs floor: the bucket grows, nothing is
    clipped, no truncation is counted."""
    smap, X, ids, K = _build_saturated_map(rng)
    mapper = LocalMapper(_cfg(ba_obs_budget=64, ba_obs_max=1024, ba_lm_budget=16, ba_lm_max=256), None)
    captured = {}
    orig = lm_mod.bundle_adjustment

    def spy(prob, iterations=10, **kw):
        captured["n_obs"] = int(np.asarray(prob.obs_mask).sum())
        captured["o_pad"] = int(prob.obs_mask.shape[0])
        return orig(prob, iterations=iterations, **kw)

    lm_mod.bundle_adjustment = spy
    try:
        mapper.local_ba(smap, N_KF - 1, iterations=8)
    finally:
        lm_mod.bundle_adjustment = orig
    assert mapper.n_ba_truncations == 0
    assert captured["n_obs"] == N_KF * N_LM  # every observation included
    assert captured["o_pad"] == 256  # grown bucket, not the 64 floor


def test_hard_cap_keeps_strongest_and_converges(rng):
    """Cap below the live observation count: truncation is counted, only
    non-window/weak observations are dropped, and BA still reduces the
    reprojection error of what remains."""
    smap, X, ids, K = _build_saturated_map(rng, noise=0.2)
    cap = 160  # < 240 live observations
    mapper = LocalMapper(
        _cfg(ba_obs_budget=64, ba_obs_max=cap, ba_lm_budget=16, ba_lm_max=256), None
    )
    captured = {}
    orig = lm_mod.bundle_adjustment

    def spy(prob, iterations=10, **kw):
        captured["obs_cam"] = np.asarray(prob.obs_cam)
        captured["mask"] = np.asarray(prob.obs_mask)
        captured["fixed"] = np.asarray(prob.fixed_cam)
        return orig(prob, iterations=iterations, **kw)

    lm_mod.bundle_adjustment = spy
    rmse_before = _reproj_rmse(smap, ids, K)
    lm_mod.bundle_adjustment = spy
    try:
        mapper.local_ba(smap, N_KF - 1, iterations=10)
    finally:
        lm_mod.bundle_adjustment = orig
    assert mapper.n_ba_truncations == 1
    live = captured["mask"].sum()
    assert live == cap
    # strength selection: every free (window) camera keeps ALL its
    # observations; the drops all come from fixed cameras' weaker edges
    obs_cam = captured["obs_cam"][captured["mask"]]
    free_cams = np.nonzero(~captured["fixed"])[0]
    counts = np.bincount(obs_cam, minlength=len(captured["fixed"]))
    for c in free_cams:
        assert counts[c] == N_LM, (c, counts[c])
    rmse_after = _reproj_rmse(smap, ids, K)
    assert rmse_after < 0.7 * rmse_before, (rmse_before, rmse_after)
