#!/usr/bin/env python
"""Smoke test of the SLAM engine on one GPU: the main path end to end.

Every phase runs in this one process (a JAX process reserves most of the
card's memory, so a second one would fail):

1. device check: the default backend must be the GPU, never the CPU;
2. the fused steady-state tracking step at 640x480, 512 features, 1024
   landmarks and a 4096-slot local map must really track;
3. the card against the plain reference (the same jnp code on the CPU
   device of this process) at real widths: ORB extraction, Hamming
   distances, pose-only optimization and one bundle-adjustment solve;
4. the whole system, synchronous, on a KITTI-00-shaped drive (1241x376,
   2000 features, production map budgets, mapping and loop closing on);
5. the whole system with asynchronous mapping on a TUM-fr1-shaped sequence.

With ``--four-cards`` it runs only distributed global BA over a four-card
mesh against single-card BA on the same production-budget problem.

Phase results go out as JSON lines; the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# ORB keypoints: FAST scores and the top-k selection are exact float
# comparisons of the same arithmetic, but the pyramid's bilinear resize and
# the blur sum in another order on the card, so a pixel whose score or a
# BRIEF pair whose intensities tie to the last bit can flip.
ORB_MIN_SAME_KEYPOINTS = 0.99
ORB_MAX_BIT_DISAGREEMENT = 0.005
# pose-only LM over ~500 edges: f32 sums in another order move the optimum
# by ~1e-6, and chi2 re-gating can flip a borderline edge, which moves it
# by up to ~1e-4; rotation entries are unitless, translations in scene
# units (depths 4-9).
POSE_MAX_ABS = 1e-3
POSE_MAX_INLIER_FLIPS = 0.01
# BA (10 LM iterations; single-card on the card vs the CPU, and four-card
# vs single-card): the Schur system is summed in another order, and the
# gauge (two fixed cameras 0.2 units apart) pins scale only weakly, so LM
# stops at solutions that differ by a small similarity whose float64 costs
# agree to ~1e-7 (4 vs 1 shards on a virtual CPU mesh: 2.4e-7 at 32 cams,
# 4.5e-8 at 256 cams, where the far cameras' translations of ~50 units
# moved 0.012). Hence the cost is held tight, rotations absolutely and
# translations and points relative to their distance from the origin.
BA_ROT_MAX_ABS = 1e-3
BA_TRANS_MAX_REL = 1e-3
BA_POINT_MAX_REL = 1e-3
BA_COST_MAX_REL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- phase 2
def phase_fused_step() -> dict:
    import jax

    from __graft_entry__ import _build_bench_state

    fn, args, _ = _build_bench_state(1)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    memory = {
        k: int(getattr(ma, k))
        for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        )
        if ma is not None and hasattr(ma, k)
    }
    frame, _, _, _, ok1, ok, n2 = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    result = {
        "valid_keypoints": int(np.asarray(frame.valid).sum()),
        "ok1": bool(ok1), "ok": bool(ok), "n2": int(n2),
        "compile_s": compile_s,
        "step_ms_median": 1e3 * float(np.median(times)),
        "memory_analysis": memory,
    }
    if not (result["ok"] and result["n2"] >= 30):
        raise AssertionError(f"fused step does not track: {result}")
    return result


# ---------------------------------------------------------------- phase 3
def _keypoint_set(frame):
    xy = np.rint(np.asarray(frame.xy_raw, np.float64) * 64).astype(np.int64)
    octave = np.asarray(frame.octave)
    valid = np.asarray(frame.valid)
    return {
        (int(xy[i, 0]), int(xy[i, 1]), int(octave[i])): i
        for i in np.nonzero(valid)[0]
    }


def compare_orb(dev, ref, image: np.ndarray, n_features: int, n_levels: int) -> dict:
    """ORB extraction on `dev` against `ref`: share of identical keypoints
    and descriptor-bit disagreement on the keypoints both found; Hamming
    distances of the reference descriptors must match exactly."""
    import jax

    from orbslam_in_practice.frontend.orb import ORBExtractor
    from orbslam_in_practice.ops.hamming import hamming_matrix, unpack_bits

    ext = ORBExtractor(n_features=n_features, n_levels=n_levels)
    f_dev = jax.device_get(ext(jax.device_put(image, dev)))
    f_ref = jax.device_get(ext(jax.device_put(image, ref)))
    k_dev, k_ref = _keypoint_set(f_dev), _keypoint_set(f_ref)
    both = sorted(set(k_dev) & set(k_ref))
    same = len(both) / max(len(k_dev), len(k_ref), 1)
    i_dev = np.array([k_dev[k] for k in both], np.int64)
    i_ref = np.array([k_ref[k] for k in both], np.int64)
    bits_dev = np.asarray(unpack_bits(f_dev.desc_packed[i_dev]))
    bits_ref = np.asarray(unpack_bits(f_ref.desc_packed[i_ref]))
    bit_dis = float((bits_dev != bits_ref).mean()) if len(both) else 1.0

    pm1 = np.asarray(f_ref.desc_pm1)
    ham_dev = np.asarray(hamming_matrix(jax.device_put(pm1, dev), jax.device_put(pm1, dev)))
    ham_ref = np.asarray(hamming_matrix(jax.device_put(pm1, ref), jax.device_put(pm1, ref)))
    result = {
        "shape": list(image.shape), "n_features": n_features, "n_levels": n_levels,
        "keypoints_dev": len(k_dev), "keypoints_ref": len(k_ref),
        "same_keypoints": same, "desc_bit_disagreement": bit_dis,
        "hamming_exact": bool(np.array_equal(ham_dev, ham_ref)),
    }
    if not (
        same >= ORB_MIN_SAME_KEYPOINTS
        and bit_dis <= ORB_MAX_BIT_DISAGREEMENT
        and result["hamming_exact"]
    ):
        raise AssertionError(f"ORB card vs reference out of bounds: {result}")
    return result


def compare_pose_opt(dev, ref, n_edges: int = 512, seed: int = 0) -> dict:
    """Pose-only optimization of one frame's matches (10% outliers)."""
    import jax

    from orbslam_in_practice.geometry.se3 import exp_se3
    from orbslam_in_practice.optim.pose_opt import pose_optimization

    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    Xw = np.stack(
        [rng.uniform(-3, 3, n_edges), rng.uniform(-2, 2, n_edges), rng.uniform(4, 9, n_edges)], -1
    ).astype(np.float32)
    T_true = np.asarray(exp_se3(np.array([0.05, -0.02, 0.1, 0.02, -0.01, 0.015], np.float32)))
    pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    uv = (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]
    uv = uv + rng.normal(size=uv.shape) * 0.7
    outl = rng.random(n_edges) < 0.1
    uv[outl] += rng.uniform(-40, 40, (int(outl.sum()), 2))
    args = (
        np.eye(4, dtype=np.float32), Xw, uv.astype(np.float32),
        np.ones(n_edges, np.float32), np.ones(n_edges, bool), K,
    )
    T_dev, in_dev, _ = jax.device_get(pose_optimization(*jax.device_put(args, dev)))
    T_ref, in_ref, _ = jax.device_get(pose_optimization(*jax.device_put(args, ref)))
    result = {
        "edges": n_edges,
        "pose_max_abs_diff": float(np.abs(T_dev - T_ref).max()),
        "inlier_flips": float((in_dev != in_ref).mean()),
        "pose_err_vs_truth": float(np.abs(T_ref - T_true).max()),
    }
    if not (
        result["pose_max_abs_diff"] <= POSE_MAX_ABS
        and result["inlier_flips"] <= POSE_MAX_INLIER_FLIPS
    ):
        raise AssertionError(f"pose_optimization card vs reference: {result}")
    return result


def ba_problem(n_cams: int, n_pts: int, obs_per_pt: int, n_shards: int, seed: int = 0):
    from bench_scaling import make_problem
    from orbslam_in_practice.parallel.dist_ba import partition_ba_problem

    poses, pts, obs_cam, obs_point, obs_uv, K = make_problem(
        np.random.default_rng(seed), n_cams=n_cams, n_pts=n_pts, obs_per_pt=obs_per_pt
    )
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return partition_ba_problem(
        poses, pts, obs_cam, obs_point, obs_uv,
        np.ones(len(obs_cam), np.float32), fixed, K, n_shards=n_shards,
    )


def ba_cost(poses, points, prob) -> float:
    """Float64 robust (Huber) reprojection cost of a single-shard problem."""
    from orbslam_in_practice.optim.ba import CHI2_MONO as d2

    K = np.asarray(prob.K, np.float64)
    P = np.asarray(poses, np.float64)
    oc, op = np.asarray(prob.obs_cam), np.asarray(prob.obs_point)
    pc = np.einsum("oij,oj->oi", P[oc, :3, :3], np.asarray(points, np.float64)[op])
    pc += P[oc, :3, 3]
    proj = pc[:, :2] / pc[:, 2:3] * np.diag(K)[:2] + K[:2, 2]
    chi2 = ((np.asarray(prob.obs_uv) - proj) ** 2).sum(-1) * np.asarray(prob.obs_inv_sigma2)
    rho = np.where(chi2 <= d2, chi2, 2.0 * np.sqrt(d2 * chi2) - d2)
    return float(rho[np.asarray(prob.obs_mask)].sum())


def check_ba(poses_a, points_a, poses_b, points_b, prob, what: str) -> dict:
    """Agreement of two BA solutions of the single-shard problem `prob`."""
    n_pts = prob.points.shape[0]
    pa, pb = np.asarray(points_a)[:n_pts], np.asarray(points_b)[:n_pts]
    cost_a, cost_b = ba_cost(poses_a, pa, prob), ba_cost(poses_b, pb, prob)
    Ta, Tb = np.asarray(poses_a), np.asarray(poses_b)
    ta, tb = Ta[:, :3, 3], Tb[:, :3, 3]
    out = {
        "rot_max_abs_diff": float(np.abs(Ta[:, :3, :3] - Tb[:, :3, :3]).max()),
        "trans_max_rel_diff": float(
            (np.linalg.norm(ta - tb, axis=-1) / np.maximum(np.linalg.norm(tb, axis=-1), 1.0)).max()
        ),
        "point_max_rel_diff": float(
            (np.linalg.norm(pa - pb, axis=-1) / np.linalg.norm(pb, axis=-1)).max()
        ),
        "cost_init": ba_cost(prob.poses, prob.points, prob),
        "cost": cost_b,
        "cost_rel_diff": abs(cost_a - cost_b) / cost_b,
    }
    if not (
        out["rot_max_abs_diff"] <= BA_ROT_MAX_ABS
        and out["trans_max_rel_diff"] <= BA_TRANS_MAX_REL
        and out["point_max_rel_diff"] <= BA_POINT_MAX_REL
        and out["cost_rel_diff"] <= BA_COST_MAX_REL
    ):
        raise AssertionError(f"{what}: {out}")
    return out


def compare_ba(dev, ref, n_cams: int = 32, n_pts: int = 4096) -> dict:
    """One local-BA-sized solve (10 LM iterations) on the card and the CPU."""
    import jax

    from orbslam_in_practice.optim.ba import bundle_adjustment

    prob = ba_problem(n_cams, n_pts, 6, n_shards=1)
    p_dev, x_dev, _ = jax.device_get(bundle_adjustment(jax.device_put(prob, dev), iterations=10))
    p_ref, x_ref, _ = jax.device_get(bundle_adjustment(jax.device_put(prob, ref), iterations=10))
    return {
        "cams": n_cams, "points": n_pts,
        **check_ba(p_dev, x_dev, p_ref, x_ref, prob, "bundle_adjustment card vs reference"),
    }


def phase_reference(dev, ref) -> dict:
    from orbslam_in_practice.io.synthetic import SyntheticSequence
    from tools.kitti_scale_probe import build

    # TUM fr1 (configs/TUM1.yaml: 1000 features, 8 levels) and the KITTI
    # probe's extractor (2000 features, 4 levels)
    tum = SyntheticSequence(n_frames=2, n_points=700, kind="strafe", seed=3).render(1)
    kitti = build(160)[0].render(1)
    return {
        "orb_640x480": compare_orb(dev, ref, tum.astype(np.float32), 1000, 8),
        "orb_1241x376": compare_orb(dev, ref, kitti.astype(np.float32), 2000, 4),
        "pose_opt": compare_pose_opt(dev, ref),
        "ba": compare_ba(dev, ref),
    }


# ---------------------------------------------------------------- phase 4
def phase_kitti(n_frames: int = 160) -> dict:
    """KITTI-00-shaped synchronous run with the gates of the slow e2e test
    (tests/test_e2e_kitti_scale.py::test_e2e_kitti_turn_regime)."""
    from tools.kitti_scale_probe import run

    t0 = time.perf_counter()
    result, system = run(n_frames=n_frames)
    wall = time.perf_counter() - t0
    system.shutdown()
    longest_loss = max((b - a + 1 for a, b in result["lost_segments"]), default=0)
    out = {
        "frames": n_frames,
        "tracked_fraction": result["tracked_fraction"],
        "longest_loss": longest_loss,
        "ate_pct_of_path": result["ate_pct_of_path"],
        "n_ba_truncations": result["mapper"]["n_ba_truncations"],
        "n_loop_closures": result["n_loop_closures"],
        "fps_slam_only": result["fps_slam_only"],
        "wall_s": wall,
        "n_kf": result["map"].get("n_kf"), "n_lm": result["map"].get("n_lm"),
    }
    if not (
        out["tracked_fraction"] > 0.9
        and longest_loss < 20
        and out["ate_pct_of_path"] < 1.5
        and out["n_ba_truncations"] == 0
    ):
        raise AssertionError(f"KITTI-shaped run failed its gates: {out}")
    return out


# ---------------------------------------------------------------- phase 5
def phase_async(n_frames: int = 60) -> dict:
    """TUM-fr1-shaped run with asynchronous mapping, gated as
    tests/test_async_mapping.py::test_async_matches_sync_quality."""
    from orbslam_in_practice.config import SlamConfig
    from orbslam_in_practice.io.evaluation import ate_rmse
    from orbslam_in_practice.io.synthetic import SyntheticSequence
    from orbslam_in_practice.slam.tracking import TrackingState
    from orbslam_in_practice.system import SlamSystem

    seq = SyntheticSequence(n_frames=n_frames, n_points=700, kind="strafe", seed=3)
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
        n_features=1000, n_levels=4, fps=10.0, async_mapping=True,
    )
    system = SlamSystem(cfg)
    t0 = time.perf_counter()
    n_tracked = 0
    for i in range(n_frames):
        n_tracked += system.track_monocular(seq.render(i), i * 0.1) is not None
    drained = system.wait_idle(timeout=300.0)
    wall = time.perf_counter() - t0
    state_ok = system.state == TrackingState.OK
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), seq.gt_centers())
    system.shutdown()
    out = {
        "frames": n_frames, "k_max": cfg.k_max, "l_max": cfg.l_max,
        "drained": bool(drained), "state_ok": bool(state_ok),
        "tracked": n_tracked, "n_aligned": int(n_aligned),
        "ate_rmse": float(rmse), "wall_s": wall,
    }
    if not (
        drained and state_ok and n_tracked > n_frames // 2
        and n_aligned > n_frames // 2 and rmse < 0.05
    ):
        raise AssertionError(f"async run failed its gates: {out}")
    return out


# ---------------------------------------------------------------- 4 cards
def phase_four_cards(n_cams: int = 256, n_pts: int = 16384) -> dict:
    """Distributed global BA over a 1-D four-card mesh against single-card
    BA on the same problem (production map budgets)."""
    import jax

    from orbslam_in_practice.optim.ba import bundle_adjustment
    from orbslam_in_practice.parallel.dist_ba import dist_bundle_adjustment
    from orbslam_in_practice.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    p_dist, x_dist = jax.device_get(
        dist_bundle_adjustment(ba_problem(n_cams, n_pts, 6, n_shards=4), mesh, iterations=10)
    )
    t_dist = time.perf_counter() - t0
    prob = ba_problem(n_cams, n_pts, 6, n_shards=1)
    t0 = time.perf_counter()
    p_one, x_one, _ = jax.device_get(
        bundle_adjustment(jax.device_put(prob, jax.devices()[0]), iterations=10)
    )
    t_one = time.perf_counter() - t0
    return {
        "cams": n_cams, "points": n_pts, "shards": 4,
        **check_ba(p_dist, x_dist, p_one, x_one, prob, "distributed vs single-card BA"),
        "dist_s_incl_compile": t_dist, "single_s_incl_compile": t_one,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only distributed global BA on four cards against one card",
    )
    args = ap.parse_args(argv)

    from orbslam_in_practice.utils import runtime

    runtime.setup()
    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: needs the GPU backend, found {jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 1
    print(f"card: {card_line()}", flush=True)
    dev = jax.devices()[0]
    emit(
        "device", jax_version=jax.__version__, kind=dev.device_kind,
        count=len(jax.devices()),
        matmul_precision=jax.config.jax_default_matmul_precision,
        compilation_cache=runtime.cache_dir(),
    )
    if args.four_cards:
        emit("four_cards", **phase_four_cards())
    else:
        ref = jax.devices("cpu")[0]
        for name, phase in (
            ("fused_step", phase_fused_step),
            ("reference", lambda: phase_reference(dev, ref)),
            ("kitti_sync", phase_kitti),
            ("tum_async", phase_async),
        ):
            t0 = time.perf_counter()
            emit(name, **phase(), phase_s=time.perf_counter() - t0)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
