"""Distributed bundle adjustment over a device mesh.

The scaling-law design (SURVEY.md §2.3, §5 'distributed communication
backend'): landmarks (and their observations) are partitioned into
contiguous blocks across the mesh axis — covisibility locality keeps each
block's observations local — while camera poses are replicated. Each device
assembles its partial Schur-reduced camera system from its landmark block;
ONE psum over the mesh produces the global (K*6, K*6) reduced system, which
every device solves identically (it is small — the whole point of Schur
marginalization); landmark back-substitution stays device-local with zero
communication.

Communication per LM iteration: psum of S (K, K, 6, 6) + b (K, 6) + two cost
scalars — independent of the landmark/observation count, so efficiency
approaches 1 as the problem grows (the >= 80% two-host target of
BASELINE.json config 5).

Tested on a virtual 8-device CPU mesh (tests/conftest.py); the same code
compiles for ICI/DCN meshes via jax.distributed.initialize on real pods.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from orbslam_in_practice.geometry.se3 import exp_se3
from orbslam_in_practice.optim.ba import (
    DENSE_ASSEMBLY_MAX_CAMS,
    BAProblem,
    build_normal_equations,
    build_point_obs,
    included_obs_mask,
    schur_solve,
    _proj_residual_jac,
    _robust_cost,
)


def partition_ba_problem(
    poses: np.ndarray,
    points: np.ndarray,
    obs_cam: np.ndarray,
    obs_point: np.ndarray,
    obs_uv: np.ndarray,
    obs_inv_sigma2: np.ndarray,
    fixed_cam: np.ndarray,
    K: np.ndarray,
    n_shards: int,
    o_max: int = 12,
):
    """Reorder a global BA problem into per-shard landmark blocks.

    Landmarks are split into n_shards contiguous blocks; each observation is
    assigned to its landmark's shard. Both the landmark and observation axes
    are padded per shard to equal sizes (fixed shapes across devices).

    Returns a BAProblem whose leading landmark/observation axes are
    (n_shards * per_shard) contiguous blocks, with obs_point/point_obs
    indices LOCAL to each shard, ready for shard_map over the first axis.
    """
    n_lm = len(points)
    lm_per = -(-n_lm // n_shards)
    l_pad = lm_per * n_shards

    # observation shard = landmark shard (locality)
    obs_shard = obs_point // lm_per
    counts = np.bincount(obs_shard, minlength=n_shards)
    o_per = max(int(counts.max()), 1)

    sh_cam = np.zeros((n_shards, o_per), np.int32)
    sh_pt = np.zeros((n_shards, o_per), np.int32)
    sh_uv = np.zeros((n_shards, o_per, 2), np.float32)
    sh_is2 = np.ones((n_shards, o_per), np.float32)
    sh_mask = np.zeros((n_shards, o_per), bool)
    sh_point_obs = np.full((n_shards, lm_per, o_max), -1, np.int32)
    for s in range(n_shards):
        sel = np.nonzero(obs_shard == s)[0]
        n = len(sel)
        sh_cam[s, :n] = obs_cam[sel]
        sh_pt[s, :n] = obs_point[sel] - s * lm_per  # local landmark index
        sh_uv[s, :n] = obs_uv[sel]
        sh_is2[s, :n] = obs_inv_sigma2[sel]
        sh_mask[s, :n] = True
        sh_point_obs[s] = build_point_obs(
            np.where(np.arange(o_per) < n, sh_pt[s], -1), lm_per, o_max
        )

    pts_pad = np.zeros((l_pad, 3), np.float32)
    pts_pad[:n_lm] = points

    return BAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(pts_pad),
        obs_cam=jnp.asarray(sh_cam.reshape(-1)),
        obs_point=jnp.asarray(sh_pt.reshape(-1)),
        obs_uv=jnp.asarray(sh_uv.reshape(-1, 2)),
        obs_inv_sigma2=jnp.asarray(sh_is2.reshape(-1)),
        obs_mask=jnp.asarray(sh_mask.reshape(-1)),
        point_obs=jnp.asarray(sh_point_obs.reshape(-1, o_max)),
        fixed_cam=jnp.asarray(fixed_cam),
        K=jnp.asarray(K),
    )


def _local_cost(poses, points, prob: BAProblem, use_huber, axis: str):
    r, _, _, _ = _proj_residual_jac(
        poses, points, prob.obs_cam, prob.obs_point, prob.obs_uv, prob.K
    )
    chi2 = jnp.sum(r * r, axis=-1) * prob.obs_inv_sigma2
    # same observation set as the normal equations (optim.ba.included_obs_mask)
    w = (prob.obs_mask & included_obs_mask(prob.point_obs, prob.obs_cam.shape[0]))
    local = jnp.sum(_robust_cost(chi2, use_huber) * w.astype(poses.dtype))
    return lax.psum(local, axis)


def make_dist_ba(mesh: Mesh, axis: str = "d", iterations: int = 10, use_huber: bool = True):
    """Build the jitted distributed-BA step for a mesh.

    Returns f(prob_partitioned) -> (poses, points) where the landmark and
    observation axes of the input are sharded over `axis` and poses are
    replicated.
    """
    pspec = BAProblem(
        poses=P(),
        points=P(axis),
        obs_cam=P(axis),
        obs_point=P(axis),
        obs_uv=P(axis),
        obs_inv_sigma2=P(axis),
        obs_mask=P(axis),
        point_obs=P(axis),
        fixed_cam=P(),
        K=P(),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec,),
        out_specs=(P(), P(axis)),
        check_vma=False,
    )
    def step(prob: BAProblem):
        # same matmul-precision policy as bundle_adjustment / pose_opt (the
        # distributed solver must not carry a LOWER accuracy floor than the
        # single-device one it is tested equivalent to)
        use_huber_arr = jnp.asarray(use_huber)
        dtype = prob.poses.dtype

        def body(_, state):
            poses, points, lam, _ = state
            local_prob = prob._replace(poses=poses, points=points)
            Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, w_g = build_normal_equations(
                poses, points, local_prob, use_huber_arr
            )
            # THE collective: reduce the camera system over the mesh
            Hcc = lax.psum(Hcc, axis)
            b_c = lax.psum(b_c, axis)
            # Schur off-diagonal terms are landmark-local, but the dense S
            # assembly must also be reduced: schur_solve scatters local
            # landmark contributions into (K, K, 6, 6); psum after assembly.
            delta_c, delta_p = _dist_schur(
                Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, prob.fixed_cam, lam, axis
            )
            free = (~prob.fixed_cam)[:, None].astype(dtype)
            poses_new = exp_se3(delta_c * free) @ poses
            points_new = points + delta_p
            cost_old = _local_cost(poses, points, local_prob, use_huber_arr, axis)
            cost_new = _local_cost(poses_new, points_new, local_prob, use_huber_arr, axis)
            ok = jnp.isfinite(cost_new) & (cost_new < cost_old)
            poses = jnp.where(ok, poses_new, poses)
            points = jnp.where(ok, points_new, points)
            lam = jnp.where(ok, lam * 0.5, lam * 4.0)
            return poses, points, lam, jnp.where(ok, cost_new, cost_old)

        with jax.default_matmul_precision("highest"):
            init = (
                prob.poses, prob.points,
                jnp.asarray(1e-4, dtype), jnp.asarray(0.0, dtype),
            )
            poses, points, _, _ = lax.fori_loop(0, iterations, body, init)
        return poses, points

    return jax.jit(step)


def _dist_schur(Hcc_global, b_c_global, Hpp, b_p, Wg, cam_g, pv, fixed_cam, lam, axis):
    """schur_solve with the S/b assembly psum'd over the mesh.

    Mirrors optim.ba.schur_solve but: the local landmark blocks contribute
    local outer-product terms; the dense reduced system is psum'd once; the
    solve is replicated; back-substitution is local.
    """
    dtype = Hcc_global.dtype
    n_cam = Hcc_global.shape[0]
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    Hcc_d = Hcc_global + lam * Hcc_global * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    from orbslam_in_practice.optim.ba import _inv3x3

    Hpp_inv = _inv3x3(Hpp_d)
    T = jnp.einsum("loij,ljk->loik", Wg, Hpp_inv)
    contrib = jnp.einsum("loik,lk->loi", T, b_p)
    if n_cam <= DENSE_ASSEMBLY_MAX_CAMS:
        # dense one-hot assembly (see optim.ba.schur_solve): the local
        # landmark block's Schur contribution as one matmul-shaped
        # contraction, no serialized scatter rows
        E = ((cam_g[..., None] == jnp.arange(n_cam)) & pv[..., None]).astype(dtype)
        A = jnp.einsum("lok,loij->lkij", E, T)
        B = jnp.einsum("lok,loij->lkij", E, Wg)
        S_local = -jnp.einsum("lkiz,lqjz->kqij", A, B)
        b_local = -jnp.einsum("lok,loi->ki", E, contrib)
    else:
        # landmark-chunked matmul assembly (optim.ba.schur_offdiag_chunked):
        # fixed memory per chunk, no (L, O, O, 6, 6) pair tensor
        from orbslam_in_practice.optim.ba import schur_offdiag_chunked

        S_local, b_local = schur_offdiag_chunked(T, Wg, contrib, cam_g, pv, n_cam)
    # one psum for the Schur terms
    S_off = lax.psum(S_local, axis)
    b_off = lax.psum(b_local, axis)

    S = S_off.at[jnp.arange(n_cam), jnp.arange(n_cam)].add(Hcc_d)
    b_red = b_c_global + b_off

    free = (~fixed_cam).astype(dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S.at[jnp.arange(n_cam), jnp.arange(n_cam)].add(
        eye6 * fixed_cam.astype(dtype)[:, None, None]
    )
    b_red = b_red * free[:, None]
    S_mat = S.transpose(0, 2, 1, 3).reshape(n_cam * 6, n_cam * 6)
    delta_c = jnp.linalg.solve(S_mat, b_red.reshape(-1)).reshape(n_cam, 6)

    dc_g = delta_c[cam_g] * pv[..., None].astype(dtype)
    Wt_dc = jnp.einsum("loij,loi->lj", Wg, dc_g)
    delta_p = jnp.einsum("lij,lj->li", Hpp_inv, b_p - Wt_dc)
    return delta_c, delta_p


def dist_bundle_adjustment(
    prob: BAProblem, mesh: Mesh, iterations: int = 10, use_huber: bool = True
):
    """Convenience wrapper: place the partitioned problem on the mesh and run."""
    axis = mesh.axis_names[0]
    step = make_dist_ba(mesh, axis, iterations, use_huber)
    sharded = jax.device_put(
        prob,
        BAProblem(
            poses=NamedSharding(mesh, P()),
            points=NamedSharding(mesh, P(axis)),
            obs_cam=NamedSharding(mesh, P(axis)),
            obs_point=NamedSharding(mesh, P(axis)),
            obs_uv=NamedSharding(mesh, P(axis)),
            obs_inv_sigma2=NamedSharding(mesh, P(axis)),
            obs_mask=NamedSharding(mesh, P(axis)),
            point_obs=NamedSharding(mesh, P(axis)),
            fixed_cam=NamedSharding(mesh, P()),
            K=NamedSharding(mesh, P()),
        ),
    )
    return step(sharded)


def distributed_global_ba(
    smap,
    K: np.ndarray,
    inv_level_sigma2: np.ndarray,
    mesh: Mesh,
    iterations: int = 10,
    fixed_kfs=(0, 1),
):
    """Distributed full-map BA straight from a SlamMap (BASELINE.json
    config 5: sharded keyframe map, distributed global BA).

    Pulls the observation table off the map, partitions landmarks over the
    mesh, runs the psum-reduced LM loop, writes the refined poses/landmarks
    back. Returns (n_cams, n_points, n_obs).
    """
    n_kf = smap.n_kf
    valid_kf = smap.kf_valid_host()[:n_kf]
    cams = [int(k) for k in range(n_kf) if valid_kf[k]]
    if len(cams) < 2:
        return 0, 0, 0
    lm_ids = np.nonzero(smap.lm_valid_host())[0]
    if len(lm_ids) == 0:
        return 0, 0, 0
    kf_idx, feat_idx, which = smap.observations_of(lm_ids)
    keep = np.isin(kf_idx, cams)
    kf_idx, feat_idx, which = kf_idx[keep], feat_idx[keep], which[keep]
    cam_slot = {k: i for i, k in enumerate(cams)}
    obs_cam = np.array([cam_slot[int(k)] for k in kf_idx], np.int32)
    obs_uv = smap.hview("kf_xy")[kf_idx, feat_idx].astype(np.float32)
    obs_oct = smap.hview("kf_octave")[kf_idx, feat_idx]
    inv_s2 = inv_level_sigma2[
        np.clip(obs_oct, 0, len(inv_level_sigma2) - 1)
    ].astype(np.float32)
    poses = smap.hview("kf_pose")[cams]
    points = smap.hview("lm_pos")[lm_ids]
    fixed = np.array([k in fixed_kfs for k in cams])
    n_shards = int(np.prod(mesh.devices.shape))
    from orbslam_in_practice.optim.ba import adaptive_o_max, count_obs_drops

    max_count = int(np.bincount(which, minlength=1).max())
    o_max = adaptive_o_max(max_count, 12, cap=24)
    dropped = count_obs_drops(which, len(lm_ids), o_max)
    if dropped:
        import logging

        logging.getLogger("orbslam").warning(
            "distributed BA dropped %d observations beyond o_max=%d", dropped, o_max
        )
    prob = partition_ba_problem(
        poses, points, obs_cam, which.astype(np.int32), obs_uv,
        inv_s2, fixed, K, n_shards=n_shards, o_max=o_max,
    )
    poses_new, points_new = dist_bundle_adjustment(prob, mesh, iterations=iterations)
    smap.set_kf_poses(cams, np.asarray(poses_new))
    smap.set_landmark_positions(lm_ids, np.asarray(points_new)[: len(lm_ids)])
    return len(cams), len(lm_ids), len(obs_cam)
