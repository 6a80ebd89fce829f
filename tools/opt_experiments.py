"""Variant experiments for extractor hot stages (run on the GPU, pick winners).

Each variant is timed with the same chained-REPS methodology as bench.py and
checked for numerical agreement against the current implementation.
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from orbslam_in_practice.utils import runtime

runtime.setup()

from orbslam_in_practice.ops.image import _gauss_kernel7, build_pyramid, gaussian_blur7
from orbslam_in_practice.ops.orb import (
    _CIRCLE31,
    _DX31,
    _DY31,
    DESC_R,
    PATCH_R,
    brief_descriptors,
    ic_angle,
)
from orbslam_in_practice.ops.orb_pattern import ORB_PATTERN
from orbslam_in_practice.ops.fast import fast_score, nms3x3

REPS = 20


def timed(name, fn, *args):
    jitted = jax.jit(fn)
    out = jitted(*args)
    float(jnp.sum(out))  # the host read waits for the device
    best = np.inf
    for _ in range(5):
        t0 = time.perf_counter()
        float(jnp.sum(jitted(*args)))
        best = min(best, (time.perf_counter() - t0) / REPS)
    print(f"{name:44s} {best*1e3:8.3f} ms/step")
    return out


def chain(stage):
    def run(img):
        def body(i, acc):
            r = stage(img + i.astype(jnp.float32) * 1e-3)
            return acc + jnp.sum(r).astype(jnp.float32)

        return lax.fori_loop(0, REPS, body, jnp.float32(0))

    return run


# ---------------- blur variants ----------------


def blur_conv_old(img):
    """The PRE-MERGE conv-based blur (kept here as the baseline variant —
    gaussian_blur7 itself is now the shift-add winner)."""
    k = jnp.asarray(_gauss_kernel7(2.0))
    x = jnp.pad(img, ((3, 3), (3, 3)), mode="edge")
    x = lax.conv_general_dilated(
        x[None, None], k[None, None, :, None], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    x = lax.conv_general_dilated(
        x, k[None, None, None, :], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return x[0, 0]


def blur_shift(img):
    k = _gauss_kernel7(2.0)
    x = jnp.pad(img, ((3, 3), (0, 0)), mode="edge")
    h, w = img.shape
    y = sum(k[i] * x[i : i + h, :] for i in range(7))
    y = jnp.pad(y, ((0, 0), (3, 3)), mode="edge")
    return sum(k[j] * y[:, j : j + w] for j in range(7))


# ---------------- pyramid variants ----------------


def _resize_weights(n_out, n_in):
    scale = n_in / n_out
    i = np.arange(n_out)
    src = (i + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(int)
    f = src - i0
    w = np.zeros((n_out, n_in), np.float32)
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    w[i, i0c] += 1 - f
    w[i, i1c] += f
    return w


def make_resize_matmul(h_in, w_in, shapes):
    mats = []
    for (h, w) in shapes[1:]:
        mats.append((jnp.asarray(_resize_weights(h, h_in)), jnp.asarray(_resize_weights(w, w_in))))

    def run(img):
        out = [img]
        for (wh, ww) in mats:
            out.append(wh @ img @ ww.T)
        return out

    return run


# ---------------- ic_angle variants ----------------


def ic_direct(img, yx):
    """Direct flat gather of the 31x31 patch + moment matvec."""
    h, w = img.shape
    offs = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1].reshape(2, -1)  # (2, 961)
    wx = jnp.asarray((_DX31 * _CIRCLE31).reshape(-1))
    wy = jnp.asarray((_DY31 * _CIRCLE31).reshape(-1))
    y = jnp.clip(yx[:, 0, None] + offs[0][None, :], 0, h - 1)
    x = jnp.clip(yx[:, 1, None] + offs[1][None, :], 0, w - 1)
    vals = jnp.take(img.reshape(-1), y * w + x, axis=0)  # (N, 961)
    m10 = vals @ wx
    m01 = vals @ wy
    return jnp.arctan2(m01, m10)


def make_ic_conv():
    kx = (_DX31 * _CIRCLE31)[None, None]  # (1,1,31,31)
    ky = (_DY31 * _CIRCLE31)[None, None]
    k = jnp.asarray(np.concatenate([kx, ky], axis=0))  # (2,1,31,31)

    def run(img, yx):
        m = lax.conv_general_dilated(
            img[None, None], k, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")
        )[0]
        m10 = m[0][yx[:, 0], yx[:, 1]]
        m01 = m[1][yx[:, 0], yx[:, 1]]
        return jnp.arctan2(m01, m10)

    return run


# ---------------- brief variants ----------------


def brief_direct(img_blur, yx, angle):
    h, w = img_blur.shape
    pat = jnp.asarray(ORB_PATTERN, dtype=jnp.float32)  # (256, 2, 2)
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    rx = jnp.round(px * ca[:, None, None] - py * sa[:, None, None]).astype(jnp.int32)
    ry = jnp.round(px * sa[:, None, None] + py * ca[:, None, None]).astype(jnp.int32)
    rx = jnp.clip(rx, -DESC_R, DESC_R)
    ry = jnp.clip(ry, -DESC_R, DESC_R)
    gy = jnp.clip(yx[:, 0, None, None] + ry, 0, h - 1)
    gx = jnp.clip(yx[:, 1, None, None] + rx, 0, w - 1)
    vals = jnp.take(img_blur.reshape(-1), (gy * w + gx).reshape(yx.shape[0], -1), axis=0)
    vals = vals.reshape(yx.shape[0], 256, 2)
    return (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)


# ---------------- fast variants ----------------


def fast_score_rolled_old(img):
    """The PRE-MERGE rolled-window FAST score (baseline variant — fast_score
    itself is now the doubling-tree winner)."""
    from orbslam_in_practice.ops.fast import _CIRCLE, _ARC

    h, w = img.shape
    neigh = jnp.stack(
        [jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1)) for (dx, dy) in _CIRCLE], axis=0
    )
    bright_m = neigh - img[None]

    def arc_score(margin):
        acc = margin
        for k in range(1, _ARC):
            acc = jnp.minimum(acc, jnp.roll(margin, -k, axis=0))
        return jnp.max(acc, axis=0)

    score = jnp.maximum(jnp.maximum(arc_score(bright_m), arc_score(-bright_m)), 0.0)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(interior, score, 0.0)


def main():
    print("backend:", jax.default_backend())
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (480, 640)), jnp.float32)
    n = 512
    yx = jnp.asarray(
        np.stack(
            [rng.integers(20, 460, n), rng.integers(20, 620, n)], axis=-1
        ).astype(np.int32)
    )

    # blur
    timed("blur conv (old baseline)", chain(blur_conv_old), img)
    timed("blur shift-add (merged)", chain(gaussian_blur7), img)
    a = np.asarray(jax.jit(blur_conv_old)(img))
    b = np.asarray(jax.jit(gaussian_blur7)(img))
    print("  blur max|diff| interior:", np.abs(a[3:-3, 3:-3] - b[3:-3, 3:-3]).max())

    # pyramid
    shapes = [(480, 640), (400, 533), (333, 444), (278, 370)]
    timed("pyramid resize (current)", chain(lambda im: sum(l.sum() for l in build_pyramid(im, 4, 1.2))), img)
    rm = make_resize_matmul(480, 640, shapes)
    timed("pyramid matmul", chain(lambda im: sum(l.sum() for l in rm(im))), img)
    a = np.asarray(jax.jit(lambda im: build_pyramid(im, 4, 1.2)[2])(img))
    b = np.asarray(jax.jit(lambda im: rm(im)[2])(img))
    print("  pyramid L2 max|diff|:", np.abs(a - b).max())

    # ic_angle
    timed("ic_angle patch (current)", chain(lambda im: ic_angle(im, yx)), img)
    timed("ic_angle direct-gather+matvec", chain(lambda im: ic_direct(im, yx)), img)
    icc = make_ic_conv()
    timed("ic_angle conv+point-gather", chain(lambda im: icc(im, yx)), img)
    a = np.asarray(jax.jit(lambda im: ic_angle(im, yx))(img))
    b = np.asarray(jax.jit(lambda im: ic_direct(im, yx))(img))
    c = np.asarray(jax.jit(lambda im: icc(im, yx))(img))
    print("  ic max|diff| direct:", np.abs(a - b).max(), " conv:", np.abs(a - c).max())

    # brief
    ang = jax.jit(lambda im: ic_angle(im, yx))(img)
    blur = jax.jit(gaussian_blur7)(img)
    timed("brief patch+take (current)", chain(lambda im: brief_descriptors(im, yx, ang).astype(jnp.float32)), blur)
    timed("brief direct-gather", chain(lambda im: brief_direct(im, yx, ang).astype(jnp.float32)), blur)
    from orbslam_in_practice.ops.hamming import pack_bits

    a = np.asarray(jax.jit(lambda im: brief_descriptors(im, yx, ang))(blur))
    b = np.asarray(jax.jit(lambda im: pack_bits(brief_direct(im, yx, ang)))(blur))
    print("  brief equal:", np.array_equal(a, b))

    # fast
    timed("fast rolled (old baseline)", chain(fast_score_rolled_old), img)
    timed("fast tree-min (merged)", chain(fast_score), img)
    a = np.asarray(jax.jit(fast_score_rolled_old)(img))
    b = np.asarray(jax.jit(fast_score)(img))
    print("  fast max|diff|:", np.abs(a - b).max())


if __name__ == "__main__":
    main()
