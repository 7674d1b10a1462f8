"""Batched 256-bit Hamming distance.

Replaces ORBmatcher::DescriptorDistance (the bit-twiddling popcount at
/root/reference/src/ORBmatcher.cc:2323) with two batched formulations:

1. `hamming_matrix` — the N x M all-pairs distance as a matmul:
   unpack each 256-bit descriptor to a +-1 vector d; then
   <da, db> = 256 - 2*hamming(a,b), so hamming = (256 - da.db)/2.
   A 2048x2048 frame-to-frame distance matrix is a single
   (2048,256)@(256,2048) bf16 matmul — this is where the FLOPs belong.

2. `hamming_pop` — elementwise XOR + population_count for the (rare) cases
   where only aligned pairs are needed.

Invalid descriptors should be masked by the caller (distances to padding
slots are garbage, not sentinel).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

N_BITS = 256


def unpack_pm1(packed: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """(N,8) uint32 -> (N,256) +-1 in `dtype` (bit=1 -> +1, bit=0 -> -1)."""
    n = packed.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(n, N_BITS)
    return (2 * bits.astype(jnp.int8) - 1).astype(dtype)


def hamming_matrix(packed_a: jnp.ndarray, packed_b: jnp.ndarray) -> jnp.ndarray:
    """(N,8),(M,8) uint32 -> (N,M) int32 Hamming distances via a matmul."""
    da = unpack_pm1(packed_a)
    db = unpack_pm1(packed_b)
    dot = jnp.dot(da, db.T, preferred_element_type=jnp.float32)
    return ((N_BITS - dot) * 0.5).astype(jnp.int32)


def hamming_pop(packed_a: jnp.ndarray, packed_b: jnp.ndarray) -> jnp.ndarray:
    """Aligned rows: (...,8),(...,8) -> (...,) int32."""
    x = jnp.bitwise_xor(packed_a, packed_b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
