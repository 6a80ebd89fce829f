"""Loop closing: place recognition + Sim3 RANSAC + essential-graph correction.

Entirely absent from the reference (SURVEY.md §0: "no LoopClosing at all";
Sim3Solver exists but is never called and returns nothing,
src/Sim3Solver.cpp). Capability per BASELINE.json config 4: Sim3 loop
closure + essential-graph optimization.

Fixed-shape design (no BoW vocabulary):
- Place recognition: each keyframe gets a global descriptor — the mean of
  its ±1 BRIEF vectors (a 256-d float "bag of bits" histogram). Candidate
  retrieval is one matvec against the keyframe table; geometric
  verification then runs only on the shortlist. This replaces DBoW2 with
  a dense matmul retrieval.
- Sim3: vmapped Horn-RANSAC over 3-point hypotheses between the matched
  landmark sets (the RANSAC wrapper + returns the reference's Sim3Solver
  lacked), gated by PIXEL reprojection error in BOTH keyframes (ORB-SLAM's
  Sim3Solver::CheckInliers semantics), refined on inliers.
- Correction: covisibility essential graph (sequential chain in keyframe
  INSERTION order — slot ids are not temporal once slots recycle — plus
  strong covisibility edges and the loop edge) optimized over Sim(3)
  (optim/pose_graph.py); landmarks corrected through their reference
  keyframe's Sim3 update (one batched transform); scale folded back to
  SE3 poses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.frontend.matcher import match_descriptor_sets
from orbslam_in_practice.geometry.sim3 import horn_sim3
from orbslam_in_practice.optim.pose_graph import optimize_pose_graph
from orbslam_in_practice.slam.place_recognition import (
    center as place_center,
)

N_HYP = 512  # 3-point all-inlier probability at a 15% inlier rate is
# ~0.4%/draw: 128 hypotheses found the true model ~40% of the time on true
# revisits (round-5 funnel, tools/sim3_recall_probe.py); 512 raises that to
# ~85% for free (one vmapped batch, Horn is tiny)
MIN_INLIERS = 20
# first-round RANSAC support worth spending a guided-expansion round on.
# Measured funnel (round 5): true revisits bootstrap at 4-6 first-round
# inliers once drift has grown, false candidates cap at 2-3 — 8 left the
# guided-expansion stage unreachable exactly when it was needed; final
# acceptance still requires MIN_INLIERS=20 under both per-view pixel chi2
# gates, which no false candidate approaches (max 3).
BOOTSTRAP_INLIERS = 4
# pixel chi2 gates, ORB-SLAM Sim3Solver convention (9.210 = chi2(2) @ 99%)
PIX_CHI2 = 9.21


@jax.jit
def _guided_match(
    p_src: jnp.ndarray,  # (N, 3) landmarks in SOURCE camera frame
    desc_src: jnp.ndarray,  # (N, 256) ±1 landmark descriptors
    valid_src: jnp.ndarray,  # (N,)
    s, R, t,  # Sim3 source-cam -> dest-cam
    xy_dst: jnp.ndarray,  # (F, 2) dest-KF feature pixels
    desc_dst: jnp.ndarray,  # (F, 256) dest-KF feature descriptors
    cand_dst: jnp.ndarray,  # (F,) dest features eligible (valid & landmark-bearing)
    K: jnp.ndarray,
    radius: jnp.ndarray,
):
    """Sim3-guided projection matching (the SearchBySim3 role of ORB-SLAM,
    which the reference has no trace of): project source landmarks into the
    destination keyframe under the current Sim3 estimate and match by
    descriptor within a pixel radius, mutual-best (cross-checked).
    Returns (N,) best destination feature per source landmark, -1 = none."""
    pc = s * p_src @ R.T + t
    z = pc[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
    d2 = (xy_dst[None, :, 0] - u[:, None]) ** 2 + (
        xy_dst[None, :, 1] - v[:, None]
    ) ** 2  # (N, F)
    ham = (
        256.0
        - desc_src.astype(jnp.float32) @ desc_dst.astype(jnp.float32).T
    ) * 0.5
    ok = (
        valid_src[:, None]
        & cand_dst[None, :]
        & (z[:, None] > 0)
        & (d2 < radius * radius)
        & (ham <= 100.0)
    )
    score = jnp.where(ok, ham, jnp.inf)
    best = jnp.argmin(score, axis=1)  # (N,)
    best_ok = jnp.isfinite(jnp.min(score, axis=1))
    # mutual best: the chosen dest feature must choose this source back
    best_of_dst = jnp.argmin(score, axis=0)  # (F,)
    mutual = best_of_dst[best] == jnp.arange(p_src.shape[0])
    return jnp.where(best_ok & mutual, best, -1)


@jax.jit
def _sim3_ransac(
    pa: jnp.ndarray,
    pb: jnp.ndarray,
    uv_a: jnp.ndarray,
    uv_b: jnp.ndarray,
    inv_sigma2_a: jnp.ndarray,
    inv_sigma2_b: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    key,
):
    """Robust similarity pb ≈ s R pa + t via vmapped 3-point Horn hypotheses.

    pa/pb are 3D points in the two keyframes' CAMERA frames; inliers are
    gated by reprojection error in PIXELS in both images (scale-free,
    unlike a 3D residual threshold): transform pa into b's frame and
    project against uv_b, and the inverse into a's frame against uv_a.

    Returns (s, R, t, inlier_mask, n_inliers).
    """
    n = pa.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, n, shape=(N_HYP, 3), replace=True, p=probs)
    w = jnp.zeros((N_HYP, n), jnp.float32).at[
        jnp.arange(N_HYP)[:, None], idx
    ].set(1.0)

    def project(p):
        z = jnp.maximum(p[:, 2], 1e-6)
        u = K[0, 0] * p[:, 0] / z + K[0, 2]
        v = K[1, 1] * p[:, 1] / z + K[1, 2]
        return jnp.stack([u, v], axis=-1), p[:, 2]

    def inliers_of(s, R, t):
        pb_hat = s * pa @ R.T + t
        pa_hat = (pb - t) @ R / jnp.maximum(s, 1e-9)
        uvb_hat, zb = project(pb_hat)
        uva_hat, za = project(pa_hat)
        e_b = jnp.sum((uvb_hat - uv_b) ** 2, axis=-1) * inv_sigma2_b
        e_a = jnp.sum((uva_hat - uv_a) ** 2, axis=-1) * inv_sigma2_a
        return valid & (e_b < PIX_CHI2) & (e_a < PIX_CHI2) & (zb > 0) & (za > 0)

    def run(wm):
        s, R, t = horn_sim3(pa, pb, w=wm)
        return s, R, t, jnp.sum(inliers_of(s, R, t))

    ss, Rs, ts, n_inl = jax.vmap(run)(w)
    best = jnp.argmax(n_inl)
    s, R, t = ss[best], Rs[best], ts[best]
    # refine on inliers
    inl = inliers_of(s, R, t)
    s, R, t = horn_sim3(pa, pb, w=inl.astype(jnp.float32))
    inl = inliers_of(s, R, t)
    return s, R, t, inl, jnp.sum(inl)


class LoopCloser:
    def __init__(self, config):
        self.cfg = config
        self.last_loop_seq = -(10**9)
        self.n_closures = 0
        self.last_closure = None  # (kf_id, cand) of the latest accepted loop

    # ---------------- place recognition ----------------

    def _global_descriptors(self, smap) -> np.ndarray:
        """(n_kf, 256) — cached per-KF mean-BRIEF descriptors (computed once
        at insertion, slam/place_recognition.py; L2-normalized)."""
        return smap.hview("kf_gdesc")[: smap.n_kf]

    def detect_candidates(self, smap, kf_id: int, n_cand: int = 3) -> list:
        """Loop candidates: top-n_cand by CENTERED global-descriptor
        similarity among keyframes that are NOT covisible, valid, and older
        than a temporal guard band (in insertion-seq units).

        RANK-ONLY by design: the mean-BRIEF cosine distribution is measured
        too compressed for any absolute or neighbor-derived floor (round 3's
        adaptive floor sat above true-revisit similarity and filtered every
        candidate — the r3 zero-closure regression; tools/gdesc_experiment.py).
        Precision is the Sim3 stage's job; the centered-similarity > 0 check
        only skips clearly-below-average candidates to save verification
        programs (true revisits measure ~+0.29 centered, unrelated ~0.0)."""
        if smap.n_kf_active() < 10:
            return []
        kf_valid = smap.kf_valid_host()[: smap.n_kf]
        g = place_center(self._global_descriptors(smap), kf_valid)
        sims = g @ g[kf_id]
        covis = smap.covisibility()
        neighbors = set(np.nonzero(covis[kf_id] >= 15)[0].tolist()) | {kf_id}
        cur_seq = int(smap.kf_seq[kf_id])
        cands = []
        for j in np.argsort(-sims):
            j = int(j)
            if sims[j] <= 0.0:
                break
            if j in neighbors or not kf_valid[j]:
                continue
            if abs(cur_seq - int(smap.kf_seq[j])) < 10:  # temporal guard
                continue
            cands.append(j)
            if len(cands) >= n_cand:
                break
        return cands

    # ---------------- geometric verification ----------------

    def _ransac_pairs(self, smap, pairs: np.ndarray, kf_id: int, cand: int, key):
        """Run the Sim3 RANSAC on (M, 4) rows [lm_cur, lm_cand, feat_cur,
        feat_cand]. Returns (s, R, t, n_inl)."""
        lm_pos = smap.hview("lm_pos")
        Ta = smap.hview("kf_pose")[kf_id]
        Tb = smap.hview("kf_pose")[cand]
        lm_a, lm_b = pairs[:, 0], pairs[:, 1]
        f_cur, f_cand = pairs[:, 2], pairs[:, 3]
        pa_cam = lm_pos[lm_b] @ Tb[:3, :3].T + Tb[:3, 3]  # candidate's view
        pb_cam = lm_pos[lm_a] @ Ta[:3, :3].T + Ta[:3, 3]  # current's view
        uv_b = smap.hview("kf_xy")[kf_id][f_cur]
        uv_a = smap.hview("kf_xy")[cand][f_cand]
        oct_b = smap.hview("kf_octave")[kf_id][f_cur]
        oct_a = smap.hview("kf_octave")[cand][f_cand]
        inv_s2 = 1.0 / np.asarray(
            [self.cfg.scale_factor ** (2 * i) for i in range(self.cfg.n_levels)],
            np.float32,
        )
        # pad bucket sized from the actual correspondence count (power-of-2,
        # floored at f_max so the common case keeps one compiled shape):
        # after guided expansion the deduped fwd+bwd+original set can exceed
        # f_max, and clipping there silently dropped the grown matches the
        # refit exists to use (ADVICE r4)
        n_pad = smap.f_max
        while n_pad < len(pairs):
            n_pad *= 2
        m = len(pairs)
        pa = np.zeros((n_pad, 3), np.float32)
        pb = np.zeros((n_pad, 3), np.float32)
        ua = np.zeros((n_pad, 2), np.float32)
        ub = np.zeros((n_pad, 2), np.float32)
        wa = np.ones(n_pad, np.float32)
        wb = np.ones(n_pad, np.float32)
        valid = np.zeros(n_pad, bool)
        pa[:m] = pa_cam[:m]
        pb[:m] = pb_cam[:m]
        ua[:m] = uv_a[:m]
        ub[:m] = uv_b[:m]
        wa[:m] = inv_s2[np.clip(oct_a[:m], 0, self.cfg.n_levels - 1)]
        wb[:m] = inv_s2[np.clip(oct_b[:m], 0, self.cfg.n_levels - 1)]
        valid[:m] = True
        s, R, t, inl, n_inl = _sim3_ransac(
            jnp.asarray(pa), jnp.asarray(pb),
            jnp.asarray(ua), jnp.asarray(ub),
            jnp.asarray(wa), jnp.asarray(wb),
            jnp.asarray(valid), jnp.asarray(self.cfg.cam.K),
            key,
        )
        return float(s), np.asarray(R), np.asarray(t), int(n_inl)

    def _guided_pairs(self, smap, kf_id: int, cand: int, s, R, t) -> np.ndarray:
        """Sim3-guided landmark-to-landmark matching in BOTH directions
        (cand->current under (s,R,t), current->cand under its inverse);
        returns (M, 4) pair rows [lm_cur, lm_cand, feat_cur, feat_cand]."""
        lm_pos = smap.hview("lm_pos")
        lm_desc = smap.hview("lm_desc_pm1")
        xy = smap.hview("kf_xy")
        fv = smap.hview("kf_feat_valid")
        obs = smap.kf_obs_host()
        K = np.asarray(self.cfg.cam.K)
        F = smap.f_max

        def side(src_kf, dst_kf, s_, R_, t_):
            """Match src_kf's landmarks into dst_kf's landmark-bearing
            features. Returns rows [lm_dst, lm_src, feat_dst, feat_src]."""
            T_src = smap.hview("kf_pose")[src_kf]
            src_feats = np.nonzero((obs[src_kf] >= 0) & fv[src_kf])[0]
            if len(src_feats) == 0:
                return np.zeros((0, 4), np.int64)
            lms = obs[src_kf][src_feats]
            p_src = np.zeros((F, 3), np.float32)
            d_src = np.zeros((F, 256), np.int8)
            v_src = np.zeros(F, bool)
            n = min(len(src_feats), F)
            p_src[:n] = (
                lm_pos[lms[:n]] @ T_src[:3, :3].T + T_src[:3, 3]
            )
            d_src[:n] = lm_desc[lms[:n]]
            v_src[:n] = True
            cand_dst = (obs[dst_kf] >= 0) & fv[dst_kf]
            m = np.asarray(
                _guided_match(
                    jnp.asarray(p_src), jnp.asarray(d_src), jnp.asarray(v_src),
                    jnp.asarray(np.float32(s_)), jnp.asarray(R_, dtype=jnp.float32),
                    jnp.asarray(t_, dtype=jnp.float32),
                    jnp.asarray(xy[dst_kf]),
                    smap.kf_desc_pm1[dst_kf],
                    jnp.asarray(cand_dst),
                    jnp.asarray(K), jnp.asarray(12.0, jnp.float32),
                )
            )
            hit = np.nonzero(m[:n] >= 0)[0]
            return np.stack(
                [
                    obs[dst_kf][m[hit]],  # lm_dst
                    lms[hit],  # lm_src
                    m[hit],  # feat_dst
                    src_feats[hit],  # feat_src
                ],
                axis=1,
            ).astype(np.int64)

        # cand -> current under (s,R,t): dst = current KF
        fwd = side(cand, kf_id, s, R, t)
        # current -> cand under the inverse Sim3
        R_inv = np.asarray(R).T
        s_inv = 1.0 / max(float(s), 1e-9)
        t_inv = -s_inv * R_inv @ np.asarray(t)
        bwd = side(kf_id, cand, s_inv, R_inv, t_inv)
        if len(bwd):
            # bwd rows are [lm_cand, lm_cur, feat_cand, feat_cur] — swap
            bwd = bwd[:, [1, 0, 3, 2]]
        return np.concatenate([fwd, bwd], axis=0)

    def compute_sim3(self, smap, kf_id: int, cand: int):
        """Associate landmarks via descriptors, fit Sim3 cand->current; on
        marginal first-round support, grow the correspondence set by
        Sim3-guided projection matching (SearchBySim3 semantics) and refit.

        Returns (ok, s, R, t, n_inliers) with (s, R, t) mapping candidate-KF
        CAMERA-frame points to current-KF CAMERA frame (the Scm of ORB-SLAM).
        """
        obs_a = smap.kf_obs_host()[kf_id]
        obs_b = smap.kf_obs_host()[cand]
        has_a = jnp.asarray(obs_a >= 0) & smap.kf_feat_valid[kf_id]
        has_b = jnp.asarray(obs_b >= 0) & smap.kf_feat_valid[cand]
        # loop-stage matching is all-vs-all (no spatial window, no BoW
        # buckets), so on repetitive texture the classic 0.75-ratio/TH_LOW
        # gate starves: true revisit pairs measured ~34 matches vs ~55 with
        # TH_HIGH + 0.9 ratio + rotation histogram. Precision is enforced
        # downstream by the Sim3 RANSAC's per-view pixel chi2 gates.
        matches = match_descriptor_sets(
            smap.kf_desc_pm1[kf_id], has_a, smap.kf_desc_pm1[cand], has_b,
            angle_a=smap.kf_angle[kf_id], angle_b=smap.kf_angle[cand],
            nn_ratio=0.9, max_dist=100, check_rotation=True,
        )
        m_h = np.asarray(matches)
        sel = np.nonzero(m_h >= 0)[0]
        if len(sel) < MIN_INLIERS:
            return False, None, None, None, 0
        pairs = np.stack(
            [obs_a[sel], obs_b[m_h[sel]], sel, m_h[sel]], axis=1
        ).astype(np.int64)
        s, R, t, n_inl = self._ransac_pairs(
            smap, pairs, kf_id, cand, jax.random.PRNGKey(2)
        )
        # marginal support: drift at the revisit shrinks the descriptor-
        # only inlier set (measured 2-17 first-round inliers on true
        # revisits, tools/sim3_recall_probe.py round 5) — grow the set
        # under the current Sim3 estimate and refit, ITERATIVELY: the
        # refined Sim3 from round 1's grown set projects more accurately
        # and recruits pairs the first (coarser) estimate missed.
        allp = pairs
        for grow_round in range(2):
            if not (BOOTSTRAP_INLIERS <= n_inl < MIN_INLIERS):
                break
            grown = self._guided_pairs(smap, kf_id, cand, s, R, t)
            if not len(grown):
                break
            allp = np.concatenate([allp, grown], axis=0)
            # dedupe by (lm_cur, lm_cand)
            _, first = np.unique(allp[:, :2], axis=0, return_index=True)
            allp = allp[np.sort(first)]
            s, R, t, n_inl = self._ransac_pairs(
                smap, allp, kf_id, cand, jax.random.PRNGKey(3 + grow_round)
            )
        if n_inl < MIN_INLIERS:
            return False, None, None, None, n_inl
        return True, s, R, t, n_inl

    # ---------------- correction ----------------

    def close_loop(self, smap, kf_id: int, cand: int, s, R, t, run_global_ba: bool = True):
        """Essential-graph optimization with the loop constraint; write back
        corrected poses and landmark positions. Fully vectorized: edges and
        landmark corrections are batched array ops (no O(K^2) Python loops)."""
        kfs = smap.valid_keyframes_by_seq()  # temporal order, recycling-safe
        n = len(kfs)
        pos_of = np.full(smap.k_max, -1, np.int64)
        pos_of[kfs] = np.arange(n)
        poses = smap.hview("kf_pose")[kfs]  # (n, 4, 4) Tcw
        S = poses.astype(np.float32)  # SE3 is Sim3 with s=1

        # edges: sequential chain (in seq order) + strong covisibility + loop
        S_inv = np.linalg.inv(S)
        chain_i = np.arange(n - 1)
        chain_j = chain_i + 1
        cv = smap.covisibility()[np.ix_(kfs, kfs)]
        cov_i, cov_j = np.nonzero(np.triu(cv >= 50, k=2))
        ei = np.concatenate([chain_i, cov_i, [pos_of[cand]]]).astype(np.int32)
        ej = np.concatenate([chain_j, cov_j, [pos_of[kf_id]]]).astype(np.int32)
        S_loop = np.eye(4, dtype=np.float32)
        S_loop[:3, :3] = s * R
        S_loop[:3, 3] = t
        meas = np.concatenate(
            [
                S[chain_j] @ S_inv[chain_i],
                S[cov_j] @ S_inv[cov_i],
                S_loop[None],
            ]
        ).astype(np.float32)
        # edge weights scale with covisibility strength (ORB-SLAM's essential
        # graph keeps only strong edges; here weaker edges get proportionally
        # less pull instead of a binary keep/drop — VERDICT r2 weak #8).
        # Chain edges floor at 1.0: consecutive keyframes anchor odometry
        # even when their covisibility is low.
        w_chain = np.maximum(cv[chain_i, chain_j].astype(np.float32) / 50.0, 1.0)
        w_cov = cv[cov_i, cov_j].astype(np.float32) / 50.0
        w = np.concatenate([w_chain, w_cov, [5.0]]).astype(np.float32)

        fixed = np.zeros(n, bool)
        fixed[pos_of[cand]] = True  # the older side anchors the graph

        S_opt = optimize_pose_graph(
            jnp.asarray(S),
            jnp.asarray(ei),
            jnp.asarray(ej),
            jnp.asarray(meas),
            jnp.asarray(w),
            jnp.asarray(fixed),
            iterations=25,
        )
        S_opt_h = np.asarray(S_opt)

        # landmark correction (batched): move each landmark with its
        # reference KF — X' = S_new^-1 * S_old * X in that KF's frame
        lm_first = smap.lm_first_kf
        lm_valid = smap.lm_valid_host()
        sel = np.nonzero(
            lm_valid & (lm_first >= 0) & (pos_of[np.maximum(lm_first, 0)] >= 0)
        )[0]
        if len(sel):
            k_pos = pos_of[lm_first[sel]]
            M = np.linalg.inv(S_opt_h)[k_pos] @ S[k_pos]  # (m, 4, 4)
            X = smap.hview("lm_pos")[sel]
            Xc = np.einsum("nij,nj->ni", M[:, :3, :3], X) + M[:, :3, 3]
            smap.set_landmark_positions(sel, Xc)

        # poses: strip scale back to SE3 (scale folds into translation)
        sR = S_opt_h[:, :3, :3]
        s_k = np.cbrt(np.linalg.det(sR))  # (n,)
        T_new = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        T_new[:, :3, :3] = sR / s_k[:, None, None]
        T_new[:, :3, 3] = S_opt_h[:, :3, 3] / s_k[:, None]  # [sR|t] ~ [R|t/s]
        smap.set_kf_poses(kfs, T_new)
        # full-map refinement after the graph correction (original ORB-SLAM's
        # RunGlobalBundleAdjustment; synchronous here)
        if run_global_ba:
            from orbslam_in_practice.slam.global_ba import (
                global_bundle_adjustment,
            )

            inv_s2 = np.array(
                [
                    1.0 / (self.cfg.scale_factor**i) ** 2
                    for i in range(self.cfg.n_levels)
                ],
                np.float32,
            )
            global_bundle_adjustment(
                smap,
                np.asarray(self.cfg.cam.K),
                inv_s2,
                iterations=10,
                fixed_kfs=(cand,),
            )
        self.n_closures += 1
        self.last_loop_seq = int(smap.kf_seq[kf_id])
        self.last_closure = (int(kf_id), int(cand))
        return True

    # ---------------- entry ----------------

    def attempt(self, smap, kf_id: int) -> bool:
        if int(smap.kf_seq[kf_id]) - self.last_loop_seq < 10:
            return False
        for cand in self.detect_candidates(smap, kf_id):
            ok, s, R, t, n_inl = self.compute_sim3(smap, kf_id, cand)
            if ok:
                return self.close_loop(smap, kf_id, cand, s, R, t)
        return False
