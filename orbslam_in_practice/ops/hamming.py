"""Hamming distance as an int8 matmul.

Replaces the reference's SWAR popcount inner loop
(src/ORBmatcher.cpp:128-144) with the matmul identity

    hamming(a, b) = (256 - <±1(a), ±1(b)>) / 2

so a full N x M distance matrix is ONE int8 matmul on the 128x128 systolic
array — the speed-of-light formulation for brute-force descriptor matching
(SURVEY.md §2.2). Descriptors are stored packed as (N, 8) uint32 and
unpacked to (N, 256) int8 once per frame.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., 256) {0,1} -> (..., 8) uint32 (little-endian bit order)."""
    b = bits.astype(jnp.uint32).reshape(bits.shape[:-1] + (8, 32))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) uint32 -> (..., 256) {0,1} uint8."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(packed.shape[:-1] + (256,)).astype(jnp.uint8)


def unpack_to_pm1(packed: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) uint32 -> (..., 256) int8 in {-1, +1}."""
    bits = unpack_bits(packed).astype(jnp.int8)
    return bits * jnp.int8(2) - jnp.int8(1)


def hamming_matrix(pm1_a: jnp.ndarray, pm1_b: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) int8 ±1, (M, 256) int8 ±1 -> (N, M) int32 Hamming distances."""
    dot = jnp.dot(
        pm1_a.astype(jnp.int8),
        pm1_b.astype(jnp.int8).T,
        preferred_element_type=jnp.int32,
    )
    return (256 - dot) // 2


def hamming_np(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """Golden model: popcount of XOR via np.unpackbits (SURVEY.md §4.1)."""
    a = np.unpackbits(packed_a.astype(">u4").view(np.uint8), axis=-1)
    b = np.unpackbits(packed_b.astype(">u4").view(np.uint8), axis=-1)
    return np.sum(a[:, None, :] != b[None, :, :], axis=-1).astype(np.int32)
