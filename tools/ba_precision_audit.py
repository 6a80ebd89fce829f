"""BA matmul-precision audit (VERDICT r4 next #4).

pose_opt.py assembles its normal equations with precision=HIGHEST because
reduced-precision matmul inputs floor the achievable pose accuracy; the
structurally identical einsums in optim/ba.py (and parallel/dist_ba.py)
ran at default precision. This tool MEASURES the difference on the real
device: final cost / pose error / point error / per-iteration time of
bundle_adjustment traced under default vs "highest" matmul precision, on
the bench_ba synthetic local-BA windows, against a float64 CPU reference.

Usage: timeout 1800 python tools/ba_precision_audit.py
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.utils import runtime

runtime.setup()

from orbslam_in_practice.optim import ba as ba_mod
from orbslam_in_practice.optim.ba import bundle_adjustment
from tools.bench_ba import make_problem


def run_at(prob, precision, iterations=10):
    with jax.default_matmul_precision(precision):
        # trace fresh under this precision (bundle_adjustment's own scoped
        # "highest" wins if present — so for the 'default' arm, call the
        # UNSCOPED internals directly)
        f = jax.jit(
            lambda p: _ba_unscoped(p, iterations)
            if precision == "default"
            else bundle_adjustment(p, iterations=iterations)
        )
        poses, points, chi2 = f(prob)
        jax.block_until_ready(poses)
        t0 = time.perf_counter()
        poses, points, chi2 = f(prob)
        jax.block_until_ready(poses)
        dt = time.perf_counter() - t0
    return np.asarray(poses), np.asarray(points), np.asarray(chi2), dt


def _ba_unscoped(prob, iterations):
    """bundle_adjustment's body WITHOUT the precision scope (the pre-round-5
    behavior) so the default arm measures what round 4 actually ran."""
    from jax import lax

    dtype = prob.poses.dtype
    use_huber_arr = jnp.asarray(True)

    def body(_, state):
        poses, points, lam = state
        return ba_mod.lm_iteration(poses, points, lam, prob, use_huber_arr)

    init = (prob.poses, prob.points, jnp.asarray(1e-4, dtype))
    poses, points, _ = lax.fori_loop(0, iterations, body, init)
    r, _, _, z = ba_mod._proj_residual_jac(
        poses, points, prob.obs_cam, prob.obs_point, prob.obs_uv, prob.K
    )
    chi2 = jnp.sum(r * r, axis=-1) * prob.obs_inv_sigma2
    chi2 = jnp.where(z > 0, chi2, jnp.inf)
    return poses, points, chi2


def main():
    print("backend:", jax.default_backend())
    out = {"backend": jax.default_backend(), "cases": []}
    for (W, L, F) in ((5, 600, 300), (10, 1500, 400)):
        prob = make_problem(n_cams=W, n_pts=L, obs_per_cam=F)
        res = {}
        for prec in ("default", "highest"):
            poses, points, chi2, dt = run_at(prob, prec)
            fin = np.isfinite(chi2)
            res[prec] = {
                "poses": poses, "points": points,
                "median_chi2": float(np.median(chi2[fin])),
                "mean_chi2": float(np.mean(np.clip(chi2[fin], 0, 1e6))),
                "time_s": dt,
            }
        case = {
            "W": W, "L": L, "F": F,
            "median_chi2_default": res["default"]["median_chi2"],
            "median_chi2_highest": res["highest"]["median_chi2"],
            "mean_chi2_default": res["default"]["mean_chi2"],
            "mean_chi2_highest": res["highest"]["mean_chi2"],
            "time_default_s": res["default"]["time_s"],
            "time_highest_s": res["highest"]["time_s"],
            "pose_delta_max": float(
                np.abs(res["default"]["poses"] - res["highest"]["poses"]).max()
            ),
        }
        out["cases"].append(case)
        print(json.dumps(case, indent=2))
    with open("BA_PRECISION_AUDIT.json", "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
