"""Sim(3) Lie group exp/log for pose-graph (essential-graph) optimization.

The reference only sketches closed-form Sim3 (src/Sim3Solver.cpp) and has no
essential-graph optimizer at all (SURVEY.md §2.1 #10 "essential graph
absent"); original ORB-SLAM uses g2o sim3 vertices. Here: matrix Sim3
G = [[s R, t], [0, 1]] with tangent xi = [rho(3), phi(3), sigma(1)].

W-matrix coefficients follow the standard Sim3 exponential (as in Sophus),
with Taylor-stable small-angle/small-sigma branches chosen via where().
"""

from __future__ import annotations

import jax.numpy as jnp

from orbslam_in_practice.geometry.se3 import exp_so3, hat, log_so3

_EPS = 1e-6


def _calc_W(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """W(phi, sigma) = int_0^1 e^(sigma u) e^(hat(phi) u) du, (..., 3, 3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    s = jnp.exp(sigma)
    Om = hat(phi)
    Om2 = Om @ Om
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), Om.shape)

    small_sigma = jnp.abs(sigma) < _EPS
    small_theta = theta < _EPS

    # sigma ~ 0 branch
    C_s0 = jnp.ones_like(sigma)
    A_s0 = jnp.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    B_s0 = jnp.where(
        small_theta, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )

    # sigma != 0 branch
    sig = jnp.where(small_sigma, 1.0, sigma)  # avoid 0-div in unused lane
    C_s = (s - 1.0) / sig
    sig2 = sig * sig
    A_th0 = ((sig - 1.0) * s + 1.0) / sig2
    B_th0 = (s * 0.5 * sig2 + s - 1.0 - sig * s) / (sig2 * sig)
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    c = theta2 + sig2
    th_safe = jnp.where(small_theta, 1.0, theta)
    A_th = (a * sig + (1.0 - b) * th_safe) / (th_safe * c)
    B_th = (C_s - ((b - 1.0) * sig + a * th_safe) / c) / jnp.maximum(theta2, 1e-24)
    A_s = jnp.where(small_theta, A_th0, A_th)
    B_s = jnp.where(small_theta, B_th0, B_th)

    A = jnp.where(small_sigma, A_s0, A_s)
    B = jnp.where(small_sigma, B_s0, B_s)
    C = jnp.where(small_sigma, C_s0, C_s)
    return (
        C[..., None, None] * eye + A[..., None, None] * Om + B[..., None, None] * Om2
    )


def exp_sim3(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 7) tangent [rho, phi, sigma] -> (..., 4, 4) Sim3 matrix."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = exp_so3(phi)
    W = _calc_W(phi, sigma)
    t = jnp.einsum("...ij,...j->...i", W, rho)
    top = jnp.concatenate([s[..., None, None] * R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype), xi.shape[:-1] + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def log_sim3(G: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) Sim3 -> (..., 7) tangent [rho, phi, sigma]."""
    sR = G[..., :3, :3]
    t = G[..., :3, 3]
    # scale from the Frobenius norm: ||sR||_F = s * sqrt(3)
    s = jnp.sqrt(jnp.maximum(jnp.sum(sR * sR, axis=(-1, -2)) / 3.0, 1e-24))
    R = sR / s[..., None, None]
    sigma = jnp.log(s)
    phi = log_so3(R)
    W = _calc_W(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_inverse(G: jnp.ndarray) -> jnp.ndarray:
    sR = G[..., :3, :3]
    t = G[..., :3, 3]
    s2 = jnp.maximum(jnp.sum(sR * sR, axis=(-1, -2)) / 3.0, 1e-24)
    inv_sR = jnp.swapaxes(sR, -1, -2) / s2[..., None, None]  # (1/s) R^T
    new_t = -jnp.einsum("...ij,...j->...i", inv_sR, t)
    top = jnp.concatenate([inv_sR, new_t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=G.dtype), G.shape[:-2] + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def se3_to_sim3(T: jnp.ndarray, s: jnp.ndarray | float = 1.0) -> jnp.ndarray:
    """SE3 matrix (+ optional scale) -> Sim3 matrix."""
    s = jnp.asarray(s, dtype=T.dtype)
    out = T.at[..., :3, :3].multiply(s[..., None, None] if s.ndim else s)
    return out


def sim3_to_se3(G: jnp.ndarray) -> tuple:
    """Sim3 -> (SE3 matrix with unit-scale rotation, scale)."""
    sR = G[..., :3, :3]
    s = jnp.sqrt(jnp.maximum(jnp.sum(sR * sR, axis=(-1, -2)) / 3.0, 1e-24))
    T = G.at[..., :3, :3].set(sR / s[..., None, None])
    return T, s
