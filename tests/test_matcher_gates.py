"""Matcher gating rules: rotation histogram, ratio test, unique assignment,
frustum gates in projection search."""

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.frontend.frame import Frame
from orbslam_in_practice.frontend.matcher import (
    _rotation_consistency,
    search_by_projection,
)
from orbslam_in_practice.ops.hamming import unpack_to_pm1


def test_rotation_consistency_keeps_dominant_bins(rng):
    n = 300
    # 280 matches share ~0 rotation; 20 are scattered
    rot = np.zeros(n, np.float32)
    rot[280:] = rng.uniform(0.8, 2.8, 20).astype(np.float32)
    matched = np.ones(n, bool)
    keep = np.asarray(
        _rotation_consistency(jnp.asarray(rot), jnp.asarray(matched))
    )
    assert keep[:280].all()
    assert not keep[280:].any()


def test_rotation_consistency_wraps_negative_angles():
    rot = np.array([-0.01, 0.01, 2 * np.pi - 0.01, 0.0], np.float32)
    matched = np.ones(4, bool)
    keep = np.asarray(_rotation_consistency(jnp.asarray(rot), jnp.asarray(matched)))
    assert keep.all()  # all in adjacent dominant bins


def _make_frame(rng, n, xy, octave=None):
    desc = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    return Frame(
        xy=jnp.asarray(xy, jnp.float32),
        xy_raw=jnp.asarray(xy, jnp.float32),
        octave=jnp.zeros(n, jnp.int32) if octave is None else jnp.asarray(octave),
        angle=jnp.zeros(n, jnp.float32),
        response=jnp.ones(n, jnp.float32),
        valid=jnp.ones(n, bool),
        desc_packed=jnp.asarray(desc),
        desc_pm1=unpack_to_pm1(jnp.asarray(desc)),
    )


def test_search_by_projection_window_and_uniqueness(rng):
    K = jnp.asarray(np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32))
    n_feat = 64
    # features on a grid
    xy = np.stack(
        [rng.uniform(50, 590, n_feat), rng.uniform(50, 430, n_feat)], axis=-1
    )
    frame = _make_frame(rng, n_feat, xy)
    # two landmarks projecting to the SAME feature location, identical desc
    target = 10
    pt = np.array(
        [
            (xy[target, 0] - 320) / 500 * 5.0,
            (xy[target, 1] - 240) / 500 * 5.0,
            5.0,
        ],
        np.float32,
    )
    pts = jnp.asarray(np.stack([pt, pt]))
    desc = jnp.tile(frame.desc_pm1[target][None], (2, 1))
    matches, proj, in_img = search_by_projection(
        pts,
        desc,
        jnp.ones(2, bool),
        jnp.zeros(2, jnp.int32),
        jnp.eye(4),
        frame,
        K,
        jnp.asarray(5.0),
        jnp.ones(4, jnp.float32),
    )
    m = np.asarray(matches)
    # exactly ONE of the two claims the feature
    assert (m == target).sum() == 1
    assert (m >= 0).sum() == 1


def test_search_by_projection_distance_gate(rng):
    K = jnp.asarray(np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32))
    n_feat = 16
    xy = np.full((n_feat, 2), 320.0)
    xy[:, 1] = 240.0
    frame = _make_frame(rng, n_feat, xy)
    pt = jnp.asarray(np.array([[0.0, 0.0, 10.0]], np.float32))
    desc = frame.desc_pm1[:1]
    common = dict(
        pts_valid=jnp.ones(1, bool),
        pts_octave=jnp.zeros(1, jnp.int32),
        Tcw=jnp.eye(4),
        frame=frame,
        K=K,
        radius=jnp.asarray(5.0),
        scale_factors=jnp.ones(4, jnp.float32),
    )
    # distance 10 within [0.8*5, 1.2*20] -> allowed
    m1, _, in1 = search_by_projection(
        pt, desc, **common,
        pts_min_dist=jnp.asarray([5.0]), pts_max_dist=jnp.asarray([20.0]),
    )
    assert bool(in1[0])
    # distance 10 outside [0.8*1, 1.2*2] -> frustum-rejected
    m2, _, in2 = search_by_projection(
        pt, desc, **common,
        pts_min_dist=jnp.asarray([1.0]), pts_max_dist=jnp.asarray([2.0]),
    )
    assert not bool(in2[0])
    assert int(m2[0]) == -1


def test_search_by_projection_viewing_angle_gate(rng):
    K = jnp.asarray(np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32))
    n_feat = 16
    xy = np.full((n_feat, 2), 320.0)
    xy[:, 1] = 240.0
    frame = _make_frame(rng, n_feat, xy)
    pt = jnp.asarray(np.array([[0.0, 0.0, 10.0]], np.float32))
    desc = frame.desc_pm1[:1]
    common = dict(
        pts_valid=jnp.ones(1, bool),
        pts_octave=jnp.zeros(1, jnp.int32),
        Tcw=jnp.eye(4),
        frame=frame,
        K=K,
        radius=jnp.asarray(5.0),
        scale_factors=jnp.ones(4, jnp.float32),
    )
    # normal facing away from the camera -> rejected
    m, _, ok = search_by_projection(
        pt, desc, pts_normal=jnp.asarray([[0.0, 0.0, -1.0]]), **common
    )
    assert not bool(ok[0])
    # normal along the viewing ray -> accepted
    m2, _, ok2 = search_by_projection(
        pt, desc, pts_normal=jnp.asarray([[0.0, 0.0, 1.0]]), **common
    )
    assert bool(ok2[0])
