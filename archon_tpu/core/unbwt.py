"""Inverse BWT on device: vectorized LF-table build + pointer-doubling walk.

The reference inverse (a6/src/bwt.c:459-478 ``unbwt_transform/unbwt_write``,
a7/src/archon.cpp:903-943 ``deCompute/deWrite``) builds the LF successor
table by a counting pass and then walks the chain sequentially — the one
inherently serial loop in the whole system (SURVEY.md section 3.4).  On the
device the table build becomes a stable sort and the walk becomes pointer
doubling:
log2(n) rounds of jump-table squaring, each a large gather.

The a4-vs-a7 convention difference survives into decode: the successor
counters roll the base index first (a4, a4/src/archon.c:255-257) or last
(a7, a7/src/archon.cpp:929-931); this is the ``sentinel`` argument.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax

from .doubling import SENT_LARGE, SENT_SMALL


def lf_successor(
    L: jnp.ndarray, base: jnp.ndarray, sentinel: str, starts: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Successor table P: P[i] = bucket_start[L[i]] + occ(i) with the base
    twist.  occ is computed with one stable sort instead of a serial counter
    roll.  ``starts`` overrides the bucket bases (the a6 'var' inverse needs
    Huffman-code-ordered buckets, see core/a6.py)."""
    n = L.shape[0]
    Li = L.astype(jnp.int32)
    counts = jnp.zeros((256,), jnp.int32).at[Li].add(1)
    # occ is always measured against byte-ordered slots (that is the order
    # the stable sort below produces); custom ``starts`` only relocate the
    # bucket bases in the final add
    natural = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
    if starts is None:
        starts = natural

    iota = lax.iota(jnp.int32, n)
    _, sorted_idx = lax.sort((Li, iota), num_keys=1)  # stable within char
    pos_in_sorted = jnp.zeros((n,), jnp.int32).at[sorted_idx].set(iota)
    occ_natural = pos_in_sorted - natural[Li]  # occurrences before i, index order

    # base processed first (a4/'small') or last (a7/'large') instead of at
    # its natural index position: adjust occurrence counts of same-char slots.
    same = (Li == Li[base]).astype(jnp.int32)
    if sentinel == SENT_SMALL:
        # base jumps to front: everyone before it with the same char shifts +1
        adj = jnp.where((iota < base) & (same == 1), 1, 0)
        occ = occ_natural + adj
        occ = occ.at[base].set(0)
    else:
        # base jumps to the end: everyone after it with the same char shifts -1
        adj = jnp.where((iota > base) & (same == 1), -1, 0)
        occ = occ_natural + adj
        occ = occ.at[base].set(counts[Li[base]] - 1)
    return starts[Li] + occ


_WALK_K = 4096  # parallel chain count of the blocked walk


def _compose_perm(g: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """c[i] = g[h[i]] for a permutation ``h`` via two sorts.

    The jump-table squaring is phrased as sort(h) -> h^-1, then
    scatter-by-sort of g onto h^-1, instead of a random n-gather (on a
    device where gathers cost more than two sorts)."""
    n = h.shape[0]
    iota = lax.iota(jnp.int32, n)
    _, inv = lax.sort((h, iota), num_keys=1)  # inv[j] = h^-1(j)
    _, c = lax.sort((inv, g), num_keys=1)  # c[inv[j]] = g[j]
    return c


def pointer_walk(L: jnp.ndarray, P: jnp.ndarray, base: jnp.ndarray) -> jnp.ndarray:
    """Emit L[base], L[P[base]], ... — the parallel answer to the serial
    chain (a6/src/bwt.c:473-478).

    Blocked cycle walk: square the jump table only up to P^K (log2(K)
    sort-compositions instead of log2(n) full-width random gathers), seed K
    equally-spaced-along-the-cycle chain heads from the doubling prefix,
    then walk all K chains in lockstep — n/K fori steps of two K-sized
    gathers, filling the output K cells per step, instead of log2(n)
    full-width squarings."""
    n = L.shape[0]
    if n <= 2 * _WALK_K:
        # small blocks: plain doubling, gathers are cheap at this size
        rounds = max(1, math.ceil(math.log2(n))) if n > 1 else 0
        pos = jnp.zeros((n,), jnp.int32).at[0].set(base)
        filled = 1
        jump = P
        for _ in range(rounds):
            take = min(filled, n - filled)
            if take > 0:
                ext = jump[lax.dynamic_slice(pos, (0,), (filled,))][:take]
                pos = lax.dynamic_update_slice(pos, ext, (filled,))
                filled += take
            if filled < n:
                jump = jump[jump]
        return L[pos]

    k = _WALK_K
    pos = jnp.zeros((k,), jnp.int32).at[0].set(base)
    filled = 1
    jump = P
    while filled < k:
        ext = jump[lax.dynamic_slice(pos, (0,), (filled,))]
        pos = lax.dynamic_update_slice(pos, ext, (filled,))
        filled *= 2
        jump = _compose_perm(jump, jump)
    # jump is now P^K; pos holds the first K walk positions

    T = -(-n // k)
    out0 = jnp.zeros((T, k), L.dtype)

    def step(t, carry):
        out, p = carry
        out = lax.dynamic_update_slice(out, L[p][None, :], (t, 0))
        return out, jump[p]

    out, _ = lax.fori_loop(0, T, step, (out0, pos))
    # cell (t, j) holds walk step t*K + j (chain j at t applications of
    # P^K to P^j(base)), so the row-major flatten is exactly walk order;
    # steps beyond n wrap the cycle and are sliced off
    return out.reshape(-1)[:n]


@functools.partial(jax.jit, static_argnames=())
def bwt_inverse_with_starts(L: jnp.ndarray, base: jnp.ndarray, starts: jnp.ndarray) -> jnp.ndarray:
    """Inverse with caller-supplied (e.g. code-ordered) bucket starts;
    base-last roll convention (the a6/a7 family)."""
    if L.shape[0] == 0:
        return jnp.zeros((0,), jnp.uint8)
    P = lf_successor(L, base, SENT_LARGE, starts)
    return pointer_walk(L, P, base)


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_inverse(L: jnp.ndarray, base: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """Invert (L, base); returns the reverse of the pre-BWT string (which for
    the a4/a7 formats is the original unreversed text — see golden/sa.py).

    Pointer doubling: out_pos[t] = P^t[base].  Round r extends the known
    prefix of the walk from 2^r to 2^(r+1) positions with one gather, while
    squaring the jump table with another — 2 n log n total gather work,
    replacing the serial n-step chain (a6/src/bwt.c:473-478).
    """
    n = L.shape[0]
    if n == 0:
        return jnp.zeros((0,), jnp.uint8)
    P = lf_successor(L, base, sentinel)
    return pointer_walk(L, P, base)
