"""Matching + extractor speed-of-light comparison (VERDICT r2 next #8).

Extends tools/bench_ba.py's roofline methodology — chained-rep timing with
genuine data dependence between reps, vs `speed_of_light_report`'s XLA
cost-analysis bounds — to the remaining hot front-end kernels BASELINE.md's
north star names ("BA AND MATCHING kernels at speed-of-light per chip"):

  - ORBExtractor (FAST+NMS, angle/blur/BRIEF) on a real
    rendered 640x480 frame — ref hot loops src/ORBextractor.cpp:745-811.
  - hamming_matrix: the int8 matmul popcount replacement for
    src/ORBmatcher.cpp:128-144, at tracking shapes (800x800) and
    map-fusion shapes (800x4096).
  - search_by_projection: steady-state tracking's matcher (the contract of
    the reference's stubbed SearchByProjection, include/ORBmatcher.h:24).

Usage: python tools/bench_frontend.py   (run on the GPU)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import lax

from orbslam_in_practice.utils import runtime

runtime.setup()

from orbslam_in_practice.frontend.matcher import search_by_projection
from orbslam_in_practice.frontend.orb import ORBExtractor
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.ops.hamming import hamming_matrix
from orbslam_in_practice.utils.profiling import speed_of_light_report


def timed_chain(make_step, x0, reps=20, trials=4):
    """Per-rep wall time of a fori_loop chaining data-dependent calls,
    measured as the SLOPE between a reps- and a 2*reps-iteration run:
    (t(2R) - t(R)) / R. Dividing one whole call by its rep count attributes
    the fixed host->device dispatch cost to per-rep compute (the
    bench_scaling.py lesson, ADVICE r2)."""

    def make(n):
        def chained(x):
            def body(i, carry):
                return make_step(carry, i)

            return lax.fori_loop(0, n, body, x)

        return jax.jit(chained)

    j1, j2 = make(reps), make(2 * reps)
    jax.block_until_ready(j1(x0))
    jax.block_until_ready(j2(x0))
    slopes = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(j1(x0))
        t1 = time.perf_counter()
        jax.block_until_ready(j2(x0))
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / reps * 1e3)
    return min(s for s in slopes if s > 0) if any(s > 0 for s in slopes) else min(slopes)


def report(name, ms, rep):
    bound = rep["t_lower_bound_s"] * 1e3
    pct = 100.0 * bound / ms if ms > 0 else float("nan")
    print(
        f"{name:<42s} {ms:8.4f} ms | flops={rep['flops']:.3e} "
        f"bytes={rep['bytes_accessed']:.3e} | t_comp={rep['t_compute_s']*1e3:.4f} "
        f"t_mem={rep['t_memory_s']*1e3:.4f} | bound={bound:.4f} ms "
        f"({pct:.0f}% of measured)"
    )


def main():
    print("backend:", jax.default_backend())
    rng = np.random.default_rng(0)
    seq = SyntheticSequence(n_frames=4, n_points=600, seed=1)
    img = jnp.asarray(seq.render(0), jnp.float32)

    # --- extractor ------------------------------------------------------
    ext = ORBExtractor(n_features=800, n_levels=4)

    def ext_step(carry, i):
        # data dependence: previous extraction's response sum perturbs the
        # next image by a sub-quantization epsilon (keeps XLA honest, does
        # not change the extraction result)
        im, acc = carry
        fr = ext._extract(im)
        s = jnp.sum(fr.response) * 1e-12
        return im + s, acc + jnp.sum(fr.xy)

    ms = timed_chain(ext_step, (img, jnp.float32(0)), reps=10)
    rep = speed_of_light_report(lambda im: ext._extract(im), img)
    report("extractor 640x480 / 800 feat / 4 lvl", ms, rep)

    # --- hamming matrix -------------------------------------------------
    # NOTE: a fake data dependence (x * where(s==0,1,1)) is a constant
    # multiply XLA simplifies away, hoisting the hamming out of the loop —
    # the first version of this bench measured 0.0004 ms, BELOW the memory
    # bound. Index a DIFFERENT query matrix per iteration instead (the
    # bench.py stacked-batch idiom): sequential fori_loop + varying input
    # means nothing is loop-invariant.
    for (N, M) in ((800, 800), (800, 4096)):
        R = 8
        a_stack = jnp.asarray(rng.integers(0, 2, (R, N, 256)) * 2 - 1, jnp.int8)
        a = a_stack[0]
        b = jnp.asarray(rng.integers(0, 2, (M, 256)) * 2 - 1, jnp.int8)

        def ham_step(carry, i, a_stack=a_stack, b=b):
            acc = carry
            x = lax.dynamic_index_in_dim(a_stack, i % R, axis=0, keepdims=False)
            d = hamming_matrix(x, b)
            # f32 accumulator: one 800x4096 sum is ~4e8, so an int32 acc
            # wraps after a few iterations (ADVICE r3) — f32 keeps the value
            # usable as a checksum while preserving the data dependence
            return acc + jnp.sum(d, dtype=jnp.float32)

        ms = timed_chain(ham_step, jnp.float32(0), reps=50)
        rep = speed_of_light_report(lambda x, y: hamming_matrix(x, y), a, b, flops="int8")
        report(f"hamming_matrix {N}x{M}", ms, rep)

    # --- search_by_projection ------------------------------------------
    frame = ext(img)
    M = 2048
    pts_w, valid = seq.backproject(
        0, np.asarray(frame.xy[:M]) if frame.n_features >= M else np.asarray(frame.xy)
    )
    pts_w = np.resize(pts_w, (M, 3)).astype(np.float32)
    desc = jnp.asarray(rng.integers(0, 2, (M, 256)) * 2 - 1, jnp.int8)
    pts_valid = jnp.asarray(np.resize(np.asarray(valid), M))
    octv = jnp.zeros(M, jnp.int32)
    K = jnp.asarray(seq.K)
    Tcw = jnp.asarray(seq.poses[1])
    sf = jnp.asarray(ext.scale_factor ** np.arange(ext.n_levels), jnp.float32)

    def sbp_step(carry, i):
        pw, acc = carry
        m, proj, in_img = search_by_projection(
            pw, desc, pts_valid, octv, Tcw, frame, K, jnp.float32(7.0), sf
        )
        return pw + jnp.sum(proj) * 1e-12, acc + jnp.sum(m)

    ms = timed_chain(sbp_step, (jnp.asarray(pts_w), jnp.int32(0)), reps=20)
    rep = speed_of_light_report(
        lambda pw: search_by_projection(
            pw, desc, pts_valid, octv, Tcw, frame, K, jnp.float32(7.0), sf
        ),
        jnp.asarray(pts_w),
    )
    report(f"search_by_projection {M} lm x 800 feat", ms, rep)


if __name__ == "__main__":
    main()
