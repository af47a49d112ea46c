"""Binary (ORB/BRIEF) descriptor ops: packing, popcount, batched Hamming.

Replaces the reference's scalar Hamming loops — `ORBmatcher::DescriptorDistance`
(ref: corbslam_client/src/ORBmatcher.cc:1788, the classic popcount bit-hack over
8 uint32 words) and `DBoW2::FORB::distance` — with a dense form:

  Hamming(a, b) = popcount(a) + popcount(b) - 2 * <bits(a), bits(b)>

so an [N, M] pairwise distance matrix is one int8 matmul (exact, int32
accumulation) plus rank-1 corrections. On an H100 this beats XOR +
population count over packed uint32 words wherever the matcher uses it
(2048x2048 and 2048x8192; PERF.md). Descriptors live in two
layouts:

  * packed:   uint8 [..., 32]   (storage, 256 bits)
  * bits:     int8  [..., 256]  (matmul operand, values in {0, 1})
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_BYTES = 32
DESC_BITS = 256

# Max possible distance + 1; used as the "invalid" sentinel in matchers.
INF_DIST = 512


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """uint8 [..., 32] -> int8 bits [..., 256] (LSB-first per byte)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*packed.shape[:-1], DESC_BITS).astype(jnp.int8)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """bits [..., 256] (any integer/bool dtype, 0/1) -> uint8 [..., 32]."""
    b = bits.reshape(*bits.shape[:-1], DESC_BYTES, 8).astype(jnp.uint8)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    return jnp.sum(b << shifts, axis=-1).astype(jnp.uint8)


def popcount_desc(packed: jnp.ndarray) -> jnp.ndarray:
    """Total popcount of packed descriptors [..., 32] -> [...] int32."""
    return jnp.sum(jax.lax.population_count(packed), axis=-1, dtype=jnp.int32)


def hamming_matrix_bits(bits_a: jnp.ndarray, bits_b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Hamming distances from bit layouts.

    bits_a: [N, 256] int8, bits_b: [M, 256] int8 -> [N, M] int32.
    One int8 matmul: d = pa + pb - 2 a.b  (exact in int32).
    """
    pa = jnp.sum(bits_a.astype(jnp.int32), axis=-1)
    pb = jnp.sum(bits_b.astype(jnp.int32), axis=-1)
    dot = jax.lax.dot_general(
        bits_a,
        bits_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return pa[:, None] + pb[None, :] - 2 * dot


def hamming_matrix(packed_a: jnp.ndarray, packed_b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Hamming distances from packed layouts: [N,32]x[M,32] -> [N,M]."""
    return hamming_matrix_bits(unpack_bits(packed_a), unpack_bits(packed_b))


def hamming_pairwise(packed_a: jnp.ndarray, packed_b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance over matching leading shapes [..., 32]."""
    return popcount_desc(jnp.bitwise_xor(packed_a, packed_b))


def masked_hamming_matrix(
    packed_a: jnp.ndarray,
    packed_b: jnp.ndarray,
    valid_a: jnp.ndarray | None = None,
    valid_b: jnp.ndarray | None = None,
    extra_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Hamming matrix with invalid entries forced to INF_DIST.

    `extra_mask` [N, M] True = allowed; replaces the reference's grid-cell /
    BoW-node / search-window candidate pruning (ORBmatcher.cc throughout)
    with a dense mask — the device computes everything and masks, instead of
    pruning with pointers.
    """
    d = hamming_matrix(packed_a, packed_b)
    mask = jnp.ones(d.shape, bool)
    if valid_a is not None:
        mask &= valid_a[:, None]
    if valid_b is not None:
        mask &= valid_b[None, :]
    if extra_mask is not None:
        mask &= extra_mask
    return jnp.where(mask, d, INF_DIST)


def best_match(
    dist: jnp.ndarray,
    max_dist: int,
    ratio: float = 1.0,
    axis: int = 1,
):
    """Row-wise best match with threshold + Lowe ratio test against 2nd best.

    Mirrors the accept rules used across ORBmatcher::Search* (ref:
    ORBmatcher.cc: TH_LOW/TH_HIGH thresholds + mfNNratio best/second checks).

    Returns (idx [N], dist [N], ok [N]) along `axis` of the [N, M] matrix.
    """
    if axis == 0:
        dist = dist.T
    neg = -dist
    top2_val, top2_idx = jax.lax.top_k(neg, 2)
    best_d = -top2_val[:, 0]
    second_d = -top2_val[:, 1]
    idx = top2_idx[:, 0]
    # Strict < mirrors the reference's `bestDist1 < mfNNratio*bestDist2`
    # (ORBmatcher.cc): two equally-good candidates are ambiguous -> reject.
    if ratio >= 1.0:
        ratio_ok = jnp.ones(best_d.shape, bool)
    else:
        ratio_ok = best_d.astype(jnp.float32) < ratio * second_d.astype(jnp.float32)
    ok = (best_d <= max_dist) & ratio_ok
    return idx, best_d, ok


def mutual_best(dist: jnp.ndarray, max_dist: int, ratio: float = 1.0):
    """Cross-check matching: keep (i, j) only when mutually the best.

    Returns (idx_a2b [N], ok [N]).
    """
    idx_ab, d_ab, ok_ab = best_match(dist, max_dist, ratio, axis=1)
    idx_ba, _, _ = best_match(dist, max_dist, 1.0, axis=0)
    mutual = jnp.take(idx_ba, idx_ab) == jnp.arange(dist.shape[0])
    return idx_ab, d_ab, ok_ab & mutual
