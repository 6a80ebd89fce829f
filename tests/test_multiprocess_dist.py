"""Two-process distributed BA: validates jax.distributed bring-up
(parallel/mesh.py::initialize_multihost), the cross-process psum path, and
the partitioner — the DCN analog the single-process virtual mesh can't see
(SURVEY.md §2.3 multi-host row; VERDICT round 1 item 5)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _single_process_reference():
    """Same problem, same shard count, one process with 8 virtual devices
    (the conftest mesh)."""
    import jax
    from jax.sharding import Mesh

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from dist_ba_worker import make_problem

    from orbslam_in_practice.parallel.dist_ba import (
        dist_bundle_adjustment,
        partition_ba_problem,
    )

    poses0, pts0, obs_cam, obs_point, obs_uv, fixed, K = make_problem()
    prob = partition_ba_problem(
        poses0, pts0, obs_cam, obs_point, obs_uv,
        np.ones(len(obs_cam), np.float32), fixed, K, n_shards=8,
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    poses_out, pts_out = dist_bundle_adjustment(prob, mesh, iterations=10)
    return np.asarray(poses_out), np.asarray(pts_out)


def test_two_process_distributed_ba(tmp_path):
    out = tmp_path / "proc0.npz"
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # keep the subprocesses off any compilation-cache lock contention
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    worker = os.path.join(REPO, "tools", "dist_ba_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
            pytest.fail(f"worker timed out:\n{stdout[-4000:]}")
        outputs.append(stdout)
    for pid, (p, stdout) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{stdout[-4000:]}"
    assert out.exists()
    data = np.load(out)

    poses_ref, pts_ref = _single_process_reference()
    # the two-process global mesh runs the SAME 8-shard computation — results
    # must agree to float tolerance (collectives reduce in a fixed order)
    assert np.allclose(data["poses"], poses_ref, atol=1e-5), np.abs(
        data["poses"] - poses_ref
    ).max()
    assert np.allclose(
        data["points"][: len(pts_ref)], pts_ref, atol=1e-4
    ), np.abs(data["points"][: len(pts_ref)] - pts_ref).max()
