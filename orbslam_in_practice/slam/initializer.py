"""Monocular two-view bootstrap: batched RANSAC H/F + model select + CheckRT.

Intended semantics of the reference's Initializer (src/Initializer.cpp:21-80
Initialize, SURVEY.md §3.3): 200 RANSAC iterations of 8 points each; both a
homography and a fundamental model are fitted and scored; model selected by
RH = S_H / (S_H + S_F) > 0.45 (:69-71); the winner is decomposed (Faugeras 8
hypotheses for H :637-763, E -> 4 for F :404-519) and each hypothesis gated by
CheckRT. The reference ran H and F on two std::threads (:64-67) — here BOTH
models' 200 hypotheses are ONE vmapped batch each; thread-level parallelism
becomes array parallelism (SURVEY.md §2.3).

Determinism: fixed jax.random key replaces DUtils::Random (:44-52).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from orbslam_in_practice.geometry.twoview import (
    check_rt,
    decompose_E,
    decompose_H,
    eight_point,
    homography_dlt,
    normalize_points,
    score_fundamental,
    score_homography,
)

N_RANSAC = 200
SAMPLE = 8


@partial(jax.jit, static_argnames=("min_inliers",))
def initialize_two_view(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    match_mask: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    sigma: float = 1.0,
    min_inliers: int = 50,
):
    """Two-view relative pose + structure from matched undistorted points.

    Args:
      p1, p2: (N, 2) matched undistorted pixels in frame 1 / frame 2
        (index-aligned; masked by match_mask).
      match_mask: (N,) bool.
      K: (3, 3) intrinsics. key: PRNG key (fixed for determinism).

    Returns dict with:
      success (bool), R (3, 3), t (3,), points3d (N, 3) in frame-1 camera
      coords, good_mask (N,), used_homography (bool), n_good.
    """
    n = p1.shape[0]
    dtype = p1.dtype

    # --- normalization (shared by all hypotheses)
    x1n, T1 = normalize_points(p1, match_mask)
    x2n, T2 = normalize_points(p2, match_mask)

    # --- RANSAC sample sets: (200, 8) indices drawn from valid matches
    probs = match_mask.astype(dtype)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(
        key, n, shape=(N_RANSAC, SAMPLE), replace=True, p=probs
    )  # sampling w/ replacement across sets; within-set dup risk is negligible
    sample_w = jnp.zeros((N_RANSAC, n), dtype).at[
        jnp.arange(N_RANSAC)[:, None], idx
    ].set(1.0)

    # --- fundamental batch
    def fit_score_F(w):
        F_n = eight_point(x1n, x2n, w)
        F = T2.T @ F_n @ T1
        s, inl = score_fundamental(F, p1, p2, match_mask, sigma)
        return s, F, inl

    sF, Fs, inlF = jax.vmap(fit_score_F)(sample_w)
    bF = jnp.argmax(sF)
    score_F, F_best, inliers_F = sF[bF], Fs[bF], inlF[bF]

    # --- homography batch
    def fit_score_H(w):
        H_n = homography_dlt(x1n, x2n, w)
        H = jnp.linalg.inv(T2) @ H_n @ T1
        s, inl = score_homography(H, p1, p2, match_mask, sigma)
        return s, H, inl

    sH, Hs, inlH = jax.vmap(fit_score_H)(sample_w)
    bH = jnp.argmax(sH)
    score_H, H_best, inliers_H = sH[bH], Hs[bH], inlH[bH]

    # --- model selection RH > 0.45 (ref :69-71)
    rh = score_H / jnp.maximum(score_H + score_F, 1e-9)
    use_H = rh > 0.45

    # --- decompose both (cheap), evaluate hypotheses of the selected model
    E = K.T @ F_best @ K
    R_f, t_f = decompose_E(E)  # (4, 3, 3), (4, 3)
    R_h, t_h, _ = decompose_H(H_best, K)  # (8, ...)
    # pad F-hypotheses to 8 so both branches have static shape 8
    R_f8 = jnp.concatenate([R_f, jnp.tile(jnp.eye(3, dtype=dtype)[None], (4, 1, 1))], 0)
    t_f8 = jnp.concatenate([t_f, jnp.ones((4, 3), dtype)], 0)
    hyp_valid_f = jnp.arange(8) < 4
    R8 = jnp.where(use_H, R_h, R_f8)
    t8 = jnp.where(use_H, t_h, t_f8)
    hyp_valid = jnp.where(use_H, jnp.ones(8, bool), hyp_valid_f)
    inliers = jnp.where(use_H, inliers_H, inliers_F)

    def eval_hyp(R, t):
        n_good, good, X, par_cos = check_rt(
            R, t, p1, p2, inliers, K, sigma2=sigma * sigma
        )
        return n_good, good, X, par_cos

    n_good8, good8, X8, par8 = jax.vmap(eval_hyp)(R8, t8)
    n_good8 = jnp.where(hyp_valid, n_good8, -1)

    best = jnp.argmax(n_good8)
    n_best = n_good8[best]
    # secondBest gate: winner must be decisive (ref CheckRT selection intent)
    sorted_n = jnp.sort(n_good8)
    n_second = sorted_n[-2]
    n_inliers = jnp.sum(inliers)
    enough = n_best >= jnp.maximum(min_inliers, (0.8 * n_inliers).astype(jnp.int32))
    decisive = n_second.astype(dtype) < 0.85 * n_best.astype(dtype)
    has_parallax = par8[best] < 0.99995
    success = enough & decisive & has_parallax

    return {
        "success": success,
        "R": R8[best],
        "t": t8[best],
        "points3d": X8[best],
        "good_mask": good8[best],
        "used_homography": use_H,
        "n_good": n_best,
        "score_F": score_F,
        "score_H": score_H,
    }
