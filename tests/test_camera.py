import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.geometry import camera

K = jnp.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], dtype=jnp.float32)
DIST = jnp.array([-0.28, 0.07, 1e-4, -2e-5, 0.0], dtype=jnp.float32)  # TUM1-like


def test_project_unproject(rng):
    pts = jnp.asarray(
        np.stack(
            [rng.uniform(-2, 2, 50), rng.uniform(-1.5, 1.5, 50), rng.uniform(2, 9, 50)],
            axis=-1,
        ),
        dtype=jnp.float32,
    )
    uv = camera.project(K, pts)
    xy = camera.unproject(K, uv)
    expect = np.asarray(pts[:, :2] / pts[:, 2:3])
    assert np.allclose(np.asarray(xy), expect, atol=1e-5)


def test_undistort_inverts_distort(rng):
    xy = jnp.asarray(rng.uniform(-0.4, 0.4, size=(100, 2)), dtype=jnp.float32)
    xyd = camera.distort_radtan(xy, DIST)
    # pixels of the distorted coords
    uv_d = jnp.stack(
        [K[0, 0] * xyd[:, 0] + K[0, 2], K[1, 1] * xyd[:, 1] + K[1, 2]], axis=-1
    )
    uv_u = camera.undistort_points(K, DIST, uv_d)
    # undistorted pixels should match pinhole projection of true normalized coords
    uv_expect = jnp.stack(
        [K[0, 0] * xy[:, 0] + K[0, 2], K[1, 1] * xy[:, 1] + K[1, 2]], axis=-1
    )
    assert np.max(np.abs(np.asarray(uv_u - uv_expect))) < 0.05


def test_image_bounds_no_distortion():
    cam = camera.CameraIntrinsics(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, dist=(0, 0, 0, 0, 0), width=640, height=480
    )
    assert camera.compute_image_bounds(cam) == (0.0, 640.0, 0.0, 480.0)


def test_image_bounds_distorted():
    cam = camera.CameraIntrinsics(
        fx=500.0,
        fy=500.0,
        cx=320.0,
        cy=240.0,
        dist=(-0.28, 0.07, 1e-4, -2e-5, 0.0),
        width=640,
        height=480,
    )
    min_x, max_x, min_y, max_y = camera.compute_image_bounds(cam)
    # barrel distortion: undistorted corners expand outward
    assert min_x < 0 and max_x > 640 and min_y < 0 and max_y > 480
