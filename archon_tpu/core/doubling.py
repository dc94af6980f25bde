"""Prefix-doubling suffix array construction in JAX (single device).

This is the JAX re-expression of the reference's GPU prefix-doubling
pipeline (gpu/Archon.boo:94-119: init -> sort -> diff -> scan -> scatter ->
jump *= 2), with two corrections over the reference kernels:

- exact tie-breaking: the reference GPU sort compares packed 4-byte keys with
  a 1-step lookahead approximation (gpu/sh/k_sort.glv:10-19); we sort exact
  (rank, next-rank) pairs so no approximation error exists.
- explicit sentinel conventions: off-end reads compare as strictly smaller
  (a4 semantics, 'small') or strictly larger (a7 semantics, 'large') than any
  real symbol, which subsumes the anchor/LSC "defense" machinery of
  a4/direct.c and final/x2 — doubling is repetition-immune by construction.

Work: O(n log n); each round is one multi-operand sort + segmented head-flag
scan + scatter, all XLA-fusable primitives.  The sort is ``jax.lax.sort``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

SENT_SMALL = "small"
SENT_LARGE = "large"

# Extended-symbol space: real byte b -> b+1 in [1, 256]; the off-end pad is 0
# (small) or 511 (large).  Three extended symbols pack into 27 bits < int31.
_EXT_BITS = 9
_EXT_BASE = 1 << _EXT_BITS  # 512


def _invert_permutation(perm: jnp.ndarray, values: jnp.ndarray):
    """values scattered to positions perm — via a sort instead of a random
    scatter (which of the two is cheaper is a property of the device)."""
    _, out = lax.sort((perm, values), num_keys=1)
    return out


def _dense_rank(keys: jnp.ndarray, idx_dtype=jnp.int32):
    """Rank every element by value (dense, ties share a rank).

    Returns (rank, num_unique). One sort + head-flag cumsum + inverse-sort."""
    n = keys.shape[0]
    iota = lax.iota(idx_dtype, n)
    sorted_keys, sorted_idx = lax.sort((keys, iota), num_keys=1)
    head = jnp.concatenate(
        [jnp.ones((1,), idx_dtype), (sorted_keys[1:] != sorted_keys[:-1]).astype(idx_dtype)]
    )
    ranks_sorted = jnp.cumsum(head) - 1
    rank = _invert_permutation(sorted_idx, ranks_sorted)
    return rank, ranks_sorted[-1] + 1


def _initial_rank(data: jnp.ndarray, sentinel: str):
    """Order-3 initial ranks: pack 3 extended symbols per position."""
    n = data.shape[0]
    ext = data.astype(jnp.int32) + 1
    pad_val = jnp.int32(0 if sentinel == SENT_SMALL else _EXT_BASE - 1)
    pad = jnp.full((2,), pad_val, jnp.int32)
    extp = jnp.concatenate([ext, pad])
    packed = (
        extp[:n] * (_EXT_BASE * _EXT_BASE)
        + extp[1 : n + 1] * _EXT_BASE
        + extp[2 : n + 2]
    )
    return _dense_rank(packed)


def _shifted_rank(padded: jnp.ndarray, iota: jnp.ndarray, n: int, k, off_end):
    """rank[i+k] with off-end sentinel, as a dynamic slice of the padded
    rank array (contiguous access — a general gather here costs ~3x more)."""
    sl = lax.dynamic_slice(padded, (jnp.minimum(k, n),), (n,))
    return jnp.where(iota + k < n, sl, off_end)


@functools.partial(jax.jit, static_argnames=("sentinel", "sort_fn"))
def suffix_array(data: jnp.ndarray, sentinel: str = SENT_SMALL, sort_fn=None) -> jnp.ndarray:
    """Suffix array of a uint8 array under the given sentinel convention.

    Matches archon_tpu.golden.sa.suffix_array exactly (tested); runs fully
    on-device under jit with a while_loop over *quadrupling* rounds: each
    round sorts (rank, rank@k, rank@2k, rank@3k) so the context length
    multiplies by 4 per sort, halving the round count vs classic doubling
    at ~20% extra per-sort cost.
    """
    n = data.shape[0]
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    if n == 1:
        return jnp.zeros((1,), jnp.int32)

    # off-end rank sentinel for refinement rounds
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)

    rank0, nuniq0 = _initial_rank(data, sentinel)
    iota = lax.iota(jnp.int32, n)

    def cond(state):
        k, rank, nuniq = state
        return jnp.logical_and(nuniq < n, k < n)

    def body(state):
        k, rank, nuniq = state
        padded = jnp.concatenate([rank, jnp.full((n,), off_end, jnp.int32)])
        r1 = _shifted_rank(padded, iota, n, k, off_end)
        r2 = _shifted_rank(padded, iota, n, 2 * k, off_end)
        r3 = _shifted_rank(padded, iota, n, 3 * k, off_end)
        if sort_fn is None:
            r0_s, r1_s, r2_s, r3_s, sorted_idx = lax.sort(
                (rank, r1, r2, r3, iota), num_keys=4
            )
        else:
            r0_s, r1_s, r2_s, r3_s, sorted_idx = sort_fn(rank, r1, r2, r3, iota)
        head = jnp.concatenate(
            [
                jnp.ones((1,), jnp.int32),
                (
                    (r0_s[1:] != r0_s[:-1])
                    | (r1_s[1:] != r1_s[:-1])
                    | (r2_s[1:] != r2_s[:-1])
                    | (r3_s[1:] != r3_s[:-1])
                ).astype(jnp.int32),
            ]
        )
        ranks_sorted = jnp.cumsum(head) - 1
        new_rank = _invert_permutation(sorted_idx, ranks_sorted)
        return k * 4, new_rank, ranks_sorted[-1] + 1

    _, rank, _ = lax.while_loop(cond, body, (jnp.int32(3), rank0, nuniq0))
    # rank is now a permutation: invert it to get the suffix array
    sa = _invert_permutation(rank, iota)
    return sa


def rank_of(sa: jnp.ndarray) -> jnp.ndarray:
    """Inverse permutation of a suffix array."""
    n = sa.shape[0]
    return jnp.zeros((n,), jnp.int32).at[sa].set(lax.iota(jnp.int32, n))


def num_doubling_rounds(n: int) -> int:
    """Upper bound on rounds executed for input length n (k: 3,6,12,... >= n)."""
    if n <= 3:
        return 1
    return 1 + math.ceil(math.log2(n / 3))
