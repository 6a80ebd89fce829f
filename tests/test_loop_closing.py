"""Loop closing: Sim3 RANSAC, place recognition, full drift correction."""

import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.geometry import se3, sim3_lie
from orbslam_in_practice.slam.loop_closing import LoopCloser, _sim3_ransac
from orbslam_in_practice.slam.map import SlamMap


def test_sim3_ransac_with_outliers(rng):
    """Pixel-gated Sim3 RANSAC: points live in two camera frames (positive
    depth); observed pixels are the projections of the (possibly corrupted)
    camera-frame points, mirroring compute_sim3's inputs."""
    n = 128
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
    pa = np.stack(
        [
            rng.uniform(-2, 2, n),
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(3, 9, n),
        ],
        axis=-1,
    ).astype(np.float32)
    R = np.asarray(se3.exp_so3(jnp.asarray([0.05, 0.2, -0.1], dtype=jnp.float32)))
    s_true, t_true = 1.3, np.array([0.5, -0.2, 0.8], np.float32)
    pb = s_true * pa @ R.T + t_true
    pb[:20] += rng.uniform(1, 3, (20, 3)).astype(np.float32)  # outliers

    def project(p):
        z = np.maximum(p[:, 2], 1e-6)
        return np.stack(
            [K[0, 0] * p[:, 0] / z + K[0, 2], K[1, 1] * p[:, 1] / z + K[1, 2]],
            axis=-1,
        ).astype(np.float32)

    uv_a = project(pa)
    uv_b = project(pb)
    ones = np.ones(n, np.float32)
    valid = np.ones(n, bool)
    s, R_est, t_est, inl, n_inl = _sim3_ransac(
        jnp.asarray(pa), jnp.asarray(pb),
        jnp.asarray(uv_a), jnp.asarray(uv_b),
        jnp.asarray(ones), jnp.asarray(ones),
        jnp.asarray(valid), jnp.asarray(K), jax.random.PRNGKey(0),
    )
    assert int(n_inl) >= 100
    assert abs(float(s) - s_true) < 0.02
    assert np.allclose(np.asarray(R_est), R, atol=0.02)


class FakeFrame:
    n_features = 256

    def __init__(self, xy, valid, desc):
        self.xy = jnp.asarray(xy)
        self.octave = jnp.zeros(256, jnp.int32)
        self.angle = jnp.zeros(256, jnp.float32)
        self.response = jnp.zeros(256, jnp.float32)
        self.valid = jnp.asarray(valid)
        self.desc_pm1 = jnp.asarray(desc)


def _make_loop_map(rng, n_kf=20):
    """A circle trajectory where the tail revisits the start WITHOUT sharing
    landmark ids (pre-closure state): the revisit keyframes observe duplicate
    landmark slots at the same world locations with the same descriptors —
    exactly what un-closed drift produces."""
    cfg = SlamConfig(fx=400.0, fy=400.0, cx=320.0, cy=240.0, k_max=32, l_max=4096, n_features=256)
    smap = SlamMap(cfg.k_max, cfg.l_max, 256)
    K = np.asarray(cfg.cam.K)

    n_world = 400
    lm_world = np.stack(
        [
            rng.uniform(-7, 7, n_world),
            rng.uniform(-2, 2, n_world),
            rng.uniform(-3, 11, n_world),
        ],
        axis=-1,
    ).astype(np.float32)
    lm_desc = (rng.integers(0, 2, (n_world, 256)).astype(np.int8) * 2 - 1)

    true_poses = []
    for k in range(n_kf):
        ang = 2 * np.pi * k / n_kf
        c = np.array([4 * np.sin(ang), 0.0, 4 - 4 * np.cos(ang)], np.float32)
        R_wc = np.asarray(
            se3.exp_so3(jnp.asarray([0.0, ang, 0.0], dtype=jnp.float32))
        ).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ c
        true_poses.append(T)

    n_tail = 4  # KFs that revisit with duplicate landmark slots
    slot_map = {}  # world lm -> duplicate slot id
    next_slot = n_world
    for k in range(n_kf):
        T = true_poses[k]
        pc = lm_world @ T[:3, :3].T + T[:3, 3]
        vis = pc[:, 2] > 0.5
        uv = (pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)) * np.diag(K)[:2] + K[:2, 2]
        vis &= (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        sel = np.nonzero(vis)[0][:80]
        xy = np.zeros((256, 2), np.float32)
        desc = np.zeros((256, 256), np.int8)
        valid = np.zeros(256, bool)
        obs = np.full(256, -1, np.int32)
        xy[: len(sel)] = uv[sel]
        desc[: len(sel)] = lm_desc[sel]
        valid[: len(sel)] = True
        if k < n_kf - n_tail:
            obs[: len(sel)] = sel
        else:
            # duplicate slots (same world point, same descriptor, new id)
            for i, w_id in enumerate(sel):
                if w_id not in slot_map:
                    slot_map[w_id] = next_slot
                    next_slot += 1
                obs[i] = slot_map[w_id]
        frame = FakeFrame(xy, valid, desc)
        smap.add_keyframe(frame, jnp.asarray(T), obs, k)

    smap.n_lm = next_slot
    smap.lm_pos = smap.lm_pos.at[:n_world].set(jnp.asarray(lm_world))
    smap.lm_desc_pm1 = smap.lm_desc_pm1.at[:n_world].set(jnp.asarray(lm_desc))
    dup_w = np.array(sorted(slot_map, key=slot_map.get), np.int64)
    dup_s = np.array([slot_map[w] for w in dup_w], np.int64)
    smap.lm_pos = smap.lm_pos.at[jnp.asarray(dup_s)].set(jnp.asarray(lm_world[dup_w]))
    smap.lm_desc_pm1 = smap.lm_desc_pm1.at[jnp.asarray(dup_s)].set(
        jnp.asarray(lm_desc[dup_w])
    )
    smap.lm_valid = smap.lm_valid.at[:next_slot].set(True)
    # landmark ownership: first KF observing each slot
    obs_all = np.asarray(smap.kf_obs[:n_kf])
    first_kf = np.full(smap.l_max, -1, np.int32)
    for k in range(n_kf - 1, -1, -1):
        s_ = obs_all[k][obs_all[k] >= 0]
        first_kf[s_] = k
    smap.lm_first_kf[:] = first_kf
    return cfg, smap, true_poses


def _inject_drift(smap, n_kf):
    """Consistent accumulating Sim3 drift on poses + owned landmarks."""
    drift = np.zeros((n_kf, 7), np.float32)
    drift[:, 1] = np.arange(n_kf) * 0.02
    drift[:, 6] = np.arange(n_kf) * 0.006
    S_drift = np.asarray(sim3_lie.exp_sim3(jnp.asarray(drift)))
    lm_pos = np.array(np.asarray(smap.lm_pos))
    poses = np.asarray(smap.kf_pose[:n_kf])
    first_kf = smap.lm_first_kf
    new_poses = []
    for k in range(n_kf):
        S_k = S_drift[k]
        Tc = poses[k] @ np.linalg.inv(S_k)
        sR = Tc[:3, :3]
        s_k = np.cbrt(np.abs(np.linalg.det(sR)))
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = sR / s_k
        T2[:3, 3] = Tc[:3, 3] / s_k
        new_poses.append(T2)
        sel = np.nonzero(first_kf == k)[0]
        if len(sel):
            Xh = np.concatenate([lm_pos[sel], np.ones((len(sel), 1), np.float32)], 1)
            lm_pos[sel] = (S_k @ Xh.T).T[:, :3]
    smap.set_kf_poses(list(range(n_kf)), np.stack(new_poses))
    ids = np.nonzero(np.asarray(smap.lm_valid))[0]
    smap.set_landmark_positions(ids, lm_pos[ids])


def test_place_recognition_finds_revisit(rng):
    cfg, smap, true_poses = _make_loop_map(rng)
    lc = LoopCloser(cfg)
    cands = lc.detect_candidates(smap, smap.n_kf - 1)
    assert any(c in (0, 1, 2, 18) for c in cands) and all(
        abs(c - (smap.n_kf - 1)) >= 10 or c < 5 for c in cands
    ), cands


def test_compute_sim3_identity_when_no_drift(rng):
    cfg, smap, true_poses = _make_loop_map(rng)
    lc = LoopCloser(cfg)
    cands = lc.detect_candidates(smap, smap.n_kf - 1)
    assert cands
    ok, s, R, t, n_inl = lc.compute_sim3(smap, smap.n_kf - 1, cands[0])
    assert ok
    # no drift: relative Sim3 between camera frames equals the true relative
    T_cur = true_poses[smap.n_kf - 1]
    T_cand = true_poses[cands[0]]
    T_rel = T_cur @ np.linalg.inv(T_cand)
    assert abs(s - 1.0) < 0.02
    assert np.allclose(R, T_rel[:3, :3], atol=0.03)


def _aligned_rmse(smap, true_poses, n):
    """Sim3-aligned RMSE of KF centers vs truth (monocular scale gauge is
    free after global BA with a single fixed camera, so absolute comparison
    is the wrong metric)."""
    from orbslam_in_practice.geometry.sim3 import horn_sim3

    est = np.stack(
        [
            -(np.asarray(smap.kf_pose[k])[:3, :3].T @ np.asarray(smap.kf_pose[k])[:3, 3])
            for k in range(n)
        ]
    )
    gt = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in true_poses])
    s, R, t = horn_sim3(jnp.asarray(est), jnp.asarray(gt))
    aligned = float(s) * est @ np.asarray(R).T + np.asarray(t)
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def test_full_loop_closure_corrects_drift(rng):
    cfg, smap, true_poses = _make_loop_map(rng)
    n = smap.n_kf
    _inject_drift(smap, n)
    err_before = _aligned_rmse(smap, true_poses, n)
    lc = LoopCloser(cfg)
    closed = lc.attempt(smap, n - 1)
    assert closed, "loop closure should trigger"
    err_after = _aligned_rmse(smap, true_poses, n)
    assert err_after < 0.5 * err_before, (err_before, err_after)
