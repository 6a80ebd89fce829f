"""Front-end: FAST parity vs golden model, Hamming parity, extractor + matcher
on synthetic imagery (SURVEY.md §4: unit goldens + component integration)."""

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.frontend.matcher import search_for_initialization
from orbslam_in_practice.frontend.orb import ORBExtractor
from orbslam_in_practice.ops import fast, hamming
from orbslam_in_practice.ops.orb import select_keypoints
from orbslam_in_practice.ops.orb_pattern import ORB_PATTERN


def render_dots(rng, h=240, w=320, n=60, seed_shift=(0, 0)):
    """Random bright blobs on a dark background — trackable corners."""
    img = np.full((h, w), 30.0, dtype=np.float32)
    pts = np.stack(
        [rng.uniform(25, w - 25, n), rng.uniform(25, h - 25, n)], axis=-1
    )
    pts = pts + np.asarray(seed_shift)
    for x, y in pts:
        xi, yi = int(x), int(y)
        if 3 <= xi < w - 4 and 3 <= yi < h - 4:
            img[yi - 2 : yi + 3, xi - 2 : xi + 3] = 220.0
    return img, pts


def test_orb_pattern_data():
    assert ORB_PATTERN.shape == (256, 2, 2)
    # canonical first pair (8,-3) -> (9,5) and value range within patch
    assert tuple(ORB_PATTERN[0, 0]) == (8, -3)
    assert tuple(ORB_PATTERN[0, 1]) == (9, 5)
    assert ORB_PATTERN.min() >= -13 and ORB_PATTERN.max() <= 12


def test_fast_score_matches_golden(rng):
    img = rng.uniform(0, 255, size=(48, 64)).astype(np.float32)
    score = np.asarray(fast.fast_score(jnp.asarray(img)))
    for th in (20.0, 7.0):
        got = score > th
        want = fast.fast_corners_np(img, th)
        assert np.array_equal(got, want)


def test_fast_nms_matches_golden_kitti_size(rng):
    """FAST + 3x3 NMS at KITTI's 1241x376 against the slow golden models,
    on full-width bands at the top, middle and bottom (the golden takes
    ~0.1 s per row): corners at both thresholds, then non-max suppression
    against a plain numpy 3x3 maximum over the whole image."""
    h, w = 376, 1241
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    score = np.asarray(fast.fast_score(jnp.asarray(img)))
    for a, b in ((0, 12), (182, 194), (h - 12, h)):
        lo, hi = max(a - 3, 0), min(b + 3, h)
        for th in (20.0, 7.0):
            want = fast.fast_corners_np(img[lo:hi], th)[a - lo : a - lo + b - a]
            assert np.array_equal(score[a:b] > th, want), (a, th)
    padded = np.pad(score, 1, constant_values=-np.inf)
    pooled = np.max(
        [padded[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)], axis=0
    )
    want = np.where(score >= pooled, score, 0.0)
    assert np.array_equal(np.asarray(fast.nms3x3(jnp.asarray(score))), want)


def test_nms_keeps_local_maxima():
    img = np.zeros((32, 32), dtype=np.float32)
    img[10, 10] = 5.0
    img[10, 11] = 3.0
    out = np.asarray(fast.nms3x3(jnp.asarray(img)))
    assert out[10, 10] == 5.0
    assert out[10, 11] == 0.0


def test_hamming_matches_golden(rng):
    a = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(24, 8), dtype=np.uint32)
    got = np.asarray(
        hamming.hamming_matrix(
            hamming.unpack_to_pm1(jnp.asarray(a)), hamming.unpack_to_pm1(jnp.asarray(b))
        )
    )
    want = hamming.hamming_np(a, b)
    assert np.array_equal(got, want)


def test_pack_unpack_roundtrip(rng):
    bits = rng.integers(0, 2, size=(8, 256)).astype(np.uint8)
    packed = hamming.pack_bits(jnp.asarray(bits))
    got = np.asarray(hamming.unpack_bits(packed))
    assert np.array_equal(got, bits)


def test_select_keypoints_spatially_uniform(rng):
    # two clusters of corners; grid selection must take from both
    score = np.zeros((128, 128), dtype=np.float32)
    score[30:40, 30:40] = rng.uniform(50, 100, (10, 10)).astype(np.float32)
    score[90:100, 90:100] = rng.uniform(10, 30, (10, 10)).astype(np.float32)
    yx, resp, valid = select_keypoints(jnp.asarray(score), budget=20, cell=32)
    yx = np.asarray(yx)[np.asarray(valid)]
    in_a = ((yx >= 25) & (yx < 45)).all(axis=1).sum()
    in_b = ((yx >= 85) & (yx < 105)).all(axis=1).sum()
    assert in_a > 0 and in_b > 0  # weaker cluster still represented


def test_extractor_finds_blobs(rng):
    img, pts = render_dots(rng)
    ext = ORBExtractor(n_features=300, n_levels=4)
    frame = ext(jnp.asarray(img))
    assert int(frame.num_valid()) > 30
    kps = np.asarray(frame.xy)[np.asarray(frame.valid)]
    # most keypoints should be near a blob corner (within ~4px of a blob)
    d = np.linalg.norm(kps[:, None, :] - pts[None, :, :], axis=-1).min(axis=1)
    assert np.median(d) < 6.0


def test_matcher_translation(rng):
    """Same blobs shifted by 6px: init matcher must recover the shift."""
    img1, pts = render_dots(rng)
    rng2 = np.random.default_rng(0)
    img2, _ = render_dots(rng2, seed_shift=(6, 0))
    ext = ORBExtractor(n_features=300, n_levels=4)
    f1 = ext(jnp.asarray(img1))
    f2 = ext(jnp.asarray(img2))
    matches = np.asarray(search_for_initialization(f1, f2, window=30))
    m = matches >= 0
    assert m.sum() > 20
    xy1 = np.asarray(f1.xy)[m]
    xy2 = np.asarray(f2.xy)[matches[m]]
    shift = np.median(xy2 - xy1, axis=0)
    assert abs(shift[0] - 6.0) < 1.5
    assert abs(shift[1]) < 1.5


def test_descriptor_rotation_tolerance(rng):
    """Descriptors of the same patch under small rotation stay close."""
    img, pts = render_dots(rng, n=40)
    ext = ORBExtractor(n_features=200, n_levels=1)
    f1 = ext(jnp.asarray(img))
    f2 = ext(jnp.asarray(img))
    # identical image -> identical descriptors
    d = np.asarray(
        hamming.hamming_matrix(f1.desc_pm1, f2.desc_pm1)
    )
    v = np.asarray(f1.valid)
    diag = np.diag(d)[v[: len(np.diag(d))]]
    assert np.all(diag == 0)
