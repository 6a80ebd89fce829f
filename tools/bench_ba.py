"""Local-BA ms/iteration benchmark + speed-of-light comparison (BASELINE.md
metric: "Local-BA ms/iter at kernel speed-of-light per chip").

Builds a realistic local-BA window (like local_mapping's: W keyframes, the
landmarks they see, ~F observations per KF), times bundle_adjustment per LM
iteration on the device (batched-input chained methodology, as bench.py),
and compares with the XLA cost-analysis roofline.
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

from orbslam_in_practice.optim.ba import BAProblem, build_point_obs, bundle_adjustment
from orbslam_in_practice.utils.profiling import speed_of_light_report


def make_problem(n_cams=6, n_pts=800, obs_per_cam=400, o_max=8, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1.0]], np.float32)
    pts = np.stack(
        [rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(3, 8, n_pts)],
        axis=-1,
    ).astype(np.float32)
    poses = []
    for c in range(n_cams):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.08 * c, 0.01 * c, 0.0]
        poses.append(T)
    poses = np.stack(poses)
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        sel = rng.choice(n_pts, size=obs_per_cam, replace=False)
        pc = pts[sel] @ poses[c][:3, :3].T + poses[c][:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * np.diag(K)[:2] + K[:2, 2]
        obs_cam += [c] * obs_per_cam
        obs_point += list(sel)
        obs_uv.append(uv + rng.normal(size=uv.shape).astype(np.float32) * 0.8)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_point = np.asarray(obs_point, np.int32)
    obs_uv = np.concatenate(obs_uv).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    prob = BAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03),
        obs_cam=jnp.asarray(obs_cam),
        obs_point=jnp.asarray(obs_point),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(len(obs_cam), jnp.float32),
        obs_mask=jnp.ones(len(obs_cam), bool),
        point_obs=jnp.asarray(build_point_obs(obs_point, n_pts, o_max)),
        fixed_cam=jnp.asarray(fixed),
        K=jnp.asarray(K),
    )
    return prob


def main():
    print("backend:", jax.default_backend())
    for (W, L, F) in ((5, 600, 300), (10, 1500, 400), (20, 4000, 500)):
        prob = make_problem(n_cams=W, n_pts=L, obs_per_cam=F)
        iters = 10
        reps = 10

        def chained(points0):
            # genuine data dependence between reps: each BA's refined points
            # seed the next rep, so nothing can be hoisted or DCE'd
            def body(i, carry):
                points, acc = carry
                p = prob._replace(points=points)
                poses, pts, chi2 = bundle_adjustment(p, iterations=iters)
                return pts, acc + jnp.sum(poses)

            pts, acc = lax.fori_loop(0, reps, body, (points0, jnp.float32(0)))
            return acc + jnp.sum(pts)

        j = jax.jit(chained)
        float(j(prob.points))
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            float(j(prob.points))
            ts.append((time.perf_counter() - t0) / (reps * iters) * 1e3)
        O = int(prob.obs_cam.shape[0])
        print(
            f"local BA W={W:3d} KF, L={L:5d} lm, O={O:5d} obs: "
            f"{min(ts):7.3f} ms/LM-iteration"
        )

    # speed-of-light report: cost-analyze exactly ONE LM iteration (XLA
    # cost analysis counts a lax loop body once regardless of trip count,
    # so analyzing bundle_adjustment(iterations=N) is not per-iteration).
    from orbslam_in_practice.optim.ba import lm_iteration

    for (W, L, F) in ((5, 600, 300), (10, 1500, 400), (20, 4000, 500)):
        prob = make_problem(W, L, F)
        rep = speed_of_light_report(
            lambda poses, points, lam: lm_iteration(
                poses, points, lam, prob, jnp.asarray(True)
            ),
            prob.poses,
            prob.points,
            jnp.float32(1e-4),
        )
        t_c = rep["t_compute_s"] * 1e3
        t_m = rep["t_memory_s"] * 1e3
        print(
            f"SoL per-iter W={W:3d}: flops={rep['flops']:.3e} "
            f"bytes={rep['bytes_accessed']:.3e} "
            f"t_compute={t_c:.4f} ms t_memory={t_m:.4f} ms "
            f"lower_bound={max(t_c, t_m):.4f} ms"
        )


if __name__ == "__main__":
    main()
