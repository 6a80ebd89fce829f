"""Pose-graph (essential-graph) optimization cost at production K.

VERDICT r3 weak #6 / next #6: the dense-jacfwd implementation built a
(K*7)^2 normal matrix by K*7 full-graph forward passes per GN iteration —
unmeasured at the KITTI run's K=89 and the production k_max=256. This
benchmarks `optimize_pose_graph` (now per-edge analytic-jacfwd + scatter
assembly) on realistic graph shapes: a sequential chain, ~3 covisibility
edges per vertex, one loop edge, 25 iterations (the close_loop call shape).

Usage: python tools/bench_pose_graph.py [--cpu]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup(cpu=args.cpu)
    import jax

    import jax.numpy as jnp
    import numpy as np

    from orbslam_in_practice.geometry import se3
    from orbslam_in_practice.optim.pose_graph import optimize_pose_graph

    rng = np.random.default_rng(0)
    print(f"backend: {jax.devices()[0].platform}")
    for K in (48, 89, 256):
        # circle trajectory with drift, chain + every-3rd covis edges + loop
        ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
        poses = []
        for k in range(K):
            c = np.array([5 * np.sin(ang[k]), 0, 5 - 5 * np.cos(ang[k])], np.float32)
            R_wc = np.asarray(se3.exp_so3(jnp.asarray([0.0, ang[k], 0.0], dtype=jnp.float32)))
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_wc.T
            T[:3, 3] = -R_wc.T @ c
            poses.append(T)
        S = np.stack(poses)
        S_inv = np.linalg.inv(S)
        ei = list(range(K - 1))
        ej = list(range(1, K))
        for k in range(0, K - 3, 3):
            ei.append(k)
            ej.append(k + 3)
        ei.append(K - 1)
        ej.append(0)
        ei = np.asarray(ei, np.int32)
        ej = np.asarray(ej, np.int32)
        meas = (S[ej] @ S_inv[ei]).astype(np.float32)
        # perturb all but the measurements (simulated drift)
        noise = rng.normal(0, 0.05, (K, 3)).astype(np.float32)
        Sp = S.copy()
        Sp[:, :3, 3] += noise
        w = np.ones(len(ei), np.float32)
        w[-1] = 5.0
        fixed = np.zeros(K, bool)
        fixed[0] = True

        argsj = (
            jnp.asarray(Sp), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(meas), jnp.asarray(w), jnp.asarray(fixed),
        )
        out = optimize_pose_graph(*argsj, iterations=25)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = optimize_pose_graph(*argsj, iterations=25)
            float(out[0, 0, 0])
        ms = (time.perf_counter() - t0) / reps * 1e3
        print(f"K={K:4d} E={len(ei):4d} 25-iter optimize: {ms:8.1f} ms")


if __name__ == "__main__":
    main()
