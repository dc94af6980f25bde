"""Forward BWT on device + always-on LF verification.

The forward transform (reference: a4/src/archon.c:227-234 ``encode``,
a7/src/archon.cpp:887-900 ``enWrite``) is a single gather off the suffix
array; the verifier is the vectorized equivalent of a4's O(N) LF-consistency
check (a4/src/archon.c:210-225 ``verify``, a7/src/archon.cpp:862-874
``validate``), jit-compiled so it can stay always-on like the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .doubling import SENT_LARGE, SENT_SMALL, rank_of, suffix_array


@functools.partial(jax.jit, static_argnames=("sentinel", "sort_fn"))
def bwt_forward(data: jnp.ndarray, sentinel: str = SENT_SMALL, sort_fn=None):
    """BWT of ``data`` (uint8): returns (L, base, sa).

    L[i] = data[(sa[i]-1) mod n]; base = rank of the full suffix.
    """
    n = data.shape[0]
    sa = suffix_array(data, sentinel, sort_fn)
    L = data[(sa - 1) % n]
    base = jnp.argmax(sa == 0).astype(jnp.int32)
    return L, base, sa


@functools.partial(jax.jit, static_argnames=("sentinel",))
def verify_sa(data: jnp.ndarray, sa: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """True iff ``sa`` is the suffix array of ``data`` under the convention.

    Checks (all O(n), fully vectorized):
      1. sa is a permutation of [0, n);
      2. adjacent sorted suffixes are strictly increasing under the
         (char, next-suffix-rank) order with sentinel semantics — the
         standard single-pass SA certificate, equivalent to the reference's
         LF walk (a4/src/archon.c:210-225).
    """
    n = data.shape[0]
    if n == 0:
        return jnp.bool_(True)
    iota = lax.iota(jnp.int32, n)
    perm_ok = jnp.all(jnp.zeros((n,), jnp.int32).at[sa].add(1) == 1)

    rank = rank_of(sa)
    # rank of the suffix following position p (sentinel rank off the end)
    off = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    nxt = jnp.where(sa + 1 < n, rank[jnp.minimum(sa + 1, n - 1)], off)
    c = data[sa].astype(jnp.int32)
    c_lt = c[:-1] < c[1:]
    c_eq = c[:-1] == c[1:]
    adj_ok = jnp.all(c_lt | (c_eq & (nxt[:-1] < nxt[1:]))) if n > 1 else jnp.bool_(True)
    return perm_ok & adj_ok


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_forward_fast(data: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Forward BWT on the narrowed (fused) suffix sorter — the production
    path.  Emits straight from the rank array: L[rank[p]] = data[p-1 mod n]
    is one scatter, and base = rank[0]; this skips the final SA inversion
    sort and the random payload gather.
    Returns (L, base, rank) — rank is the inverse SA."""
    from .fast import suffix_ranks_fused

    n = data.shape[0]
    rank = suffix_ranks_fused(data, sentinel)
    prev = jnp.roll(data, 1)
    L = jnp.zeros((n,), jnp.uint8).at[rank].set(prev)
    base = rank[0]
    return L, base, rank
