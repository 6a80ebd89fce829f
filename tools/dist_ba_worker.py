"""Worker for the two-process distributed-BA test (DCN-analog validation).

Each process hosts 4 virtual CPU devices; the two processes form one
8-device global mesh via jax.distributed (the multi-host bring-up path,
parallel/mesh.py::initialize_multihost — the role NCCL/MPI bootstrap plays
elsewhere). Both processes build the SAME deterministic BA problem, run the
psum-reduced distributed LM loop over the global mesh, and process 0 writes
the result for comparison against the single-process 8-device answer.

Usage: python tools/dist_ba_worker.py <pid> <nprocs> <port> <out.npz>
"""

from __future__ import annotations

import os
import sys


def main():
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = int(sys.argv[3])
    out_path = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from orbslam_in_practice.parallel.mesh import initialize_multihost

    initialize_multihost(
        coordinator=f"localhost:{port}", num_processes=nprocs, process_id=pid
    )
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh

    from orbslam_in_practice.geometry import se3
    from orbslam_in_practice.parallel.dist_ba import (
        dist_bundle_adjustment,
        partition_ba_problem,
    )

    poses0, pts0, obs_cam, obs_point, obs_uv, fixed, K = make_problem()
    prob = partition_ba_problem(
        poses0, pts0, obs_cam, obs_point, obs_uv,
        np.ones(len(obs_cam), np.float32), fixed, K,
        n_shards=4 * nprocs,
    )
    mesh = Mesh(np.array(jax.devices()), ("d",))
    poses_out, pts_out = dist_bundle_adjustment(prob, mesh, iterations=10)
    # poses are replicated (readable everywhere); points are landmark-sharded
    # across processes -> allgather to reassemble the global table
    pts_full = multihost_utils.process_allgather(pts_out, tiled=True)
    if pid == 0:
        np.savez(out_path, poses=np.asarray(poses_out), points=np.asarray(pts_full))
    multihost_utils.sync_global_devices("dist_ba_worker_done")
    print(f"worker {pid}: ok", flush=True)


def make_problem():
    """Deterministic small BA problem (shared by the test's single-process
    reference run — keep in sync with tests/test_multiprocess_dist.py)."""
    import jax.numpy as jnp
    import numpy as np

    from orbslam_in_practice.geometry import se3

    rng = np.random.default_rng(7)
    n_cams, n_pts = 4, 64
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    pts = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 12, n_pts)],
        axis=-1,
    ).astype(np.float32)
    poses = []
    for c in range(n_cams):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(
            se3.exp_so3(jnp.asarray(rng.normal(size=3) * 0.02, dtype=jnp.float32))
        )
        T[:3, 3] = np.array([0.25 * c, 0.01 * c, 0.0])
        poses.append(T)
    poses = np.stack(poses)
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        pc = pts @ poses[c][:3, :3].T + poses[c][:3, 3]
        uv = (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]
        for p in range(n_pts):
            obs_cam.append(c)
            obs_point.append(p)
            obs_uv.append(uv[p])
    # perturb away from the optimum (deterministic)
    poses_pert = poses.copy()
    poses_pert[2:] = np.asarray(
        se3.exp_se3(jnp.asarray(rng.normal(size=(n_cams - 2, 6)) * 0.03, dtype=jnp.float32))
    ) @ poses_pert[2:]
    pts_pert = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.08
    fixed = np.zeros(n_cams, bool)
    fixed[0] = fixed[1] = True
    return (
        poses_pert,
        pts_pert,
        np.asarray(obs_cam, np.int32),
        np.asarray(obs_point, np.int32),
        np.asarray(obs_uv, np.float32),
        fixed,
        K,
    )


if __name__ == "__main__":
    main()
