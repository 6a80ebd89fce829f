"""Native C++ frame loader: decode parity + prefetch queue ordering."""

import numpy as np
import pytest

from orbslam_in_practice.io import native_loader


def write_pgm(path, img, binary=True):
    h, w = img.shape
    if binary:
        with open(path, "wb") as f:
            f.write(f"P5\n# test\n{w} {h}\n255\n".encode())
            f.write(img.astype(np.uint8).tobytes())
    else:
        with open(path, "w") as f:
            f.write(f"P2\n{w} {h}\n255\n")
            f.write(" ".join(str(int(v)) for v in img.reshape(-1)))


def write_ppm(path, rgb):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def native_ok():
    if not native_loader.available():
        pytest.skip("native toolchain unavailable")
    return True


def test_read_pgm_binary(tmp_path, rng, native_ok):
    img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    p = tmp_path / "a.pgm"
    write_pgm(str(p), img)
    got = native_loader.read_image(str(p))
    assert got is not None
    assert got.shape == (48, 64)
    assert np.array_equal(got, img.astype(np.float32))


def test_read_pgm_ascii(tmp_path, rng, native_ok):
    img = rng.integers(0, 256, (8, 12)).astype(np.uint8)
    p = tmp_path / "a2.pgm"
    write_pgm(str(p), img, binary=False)
    got = native_loader.read_image(str(p))
    assert np.array_equal(got, img.astype(np.float32))


def test_read_ppm_grayscale_conversion(tmp_path, rng, native_ok):
    rgb = rng.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    p = tmp_path / "c.ppm"
    write_ppm(str(p), rgb)
    got = native_loader.read_image(str(p))
    want = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    assert np.allclose(got, want, atol=1e-3)


def test_prefetch_queue_order(tmp_path, rng, native_ok):
    paths = []
    imgs = []
    for i in range(12):
        img = rng.integers(0, 256, (32, 40)).astype(np.uint8)
        p = tmp_path / f"f{i:03d}.pgm"
        write_pgm(str(p), img)
        paths.append(str(p))
        imgs.append(img)
    q = native_loader.PrefetchQueue(paths, prefetch=4, n_threads=3)
    seen = []
    for idx, img in q:
        seen.append(idx)
        assert np.array_equal(img, imgs[idx].astype(np.float32))
    q.close()
    assert seen == list(range(12))


def test_missing_file_returns_none(native_ok):
    assert native_loader.read_image("/nonexistent/path.pgm") is None
