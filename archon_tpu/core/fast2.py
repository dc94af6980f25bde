"""Measurement-tuned fused suffix sorter (v2 of core.fast).

Restructured around one cost model: a multi-key sort slot is cheap next
to a random gather or scatter of the same width, and gather/scatter cost
falls with the number of indices touched.  (The primitive table behind
that model predates the GPU and is to be measured again there.)

Consequences implemented here (deltas vs core.fast):

1. Narrowed (active-set) rounds are *gather-bound*: refining C actives costs
   3-4 random gathers of C, so narrowing only pays once C <= n/16 — the v1
   n/4 stage cost MORE than a full-width round.  Thresholds: full rounds
   while actives > n/16, then capacities n/16 and n/256.
2. The group-head rank r0 of each active suffix is *carried* through the
   narrowed loop (it equals the refined rank computed the round before), so
   each narrowed round performs 3 gathers (r@k, r@2k, r@3k), not 4.
3. Compaction reuses the preceding full round's own sorted order (its
   sorted_idx / head flags ride along in the loop state), replacing v1's
   _compact (two full-width sorts) with one.
4. Keys stay multi-operand int32 rather than packed int64 (a 64-bit key
   sort can cost more than the extra int32 operands).

The quadrupling-round structure (sort rank, r@k, r@2k, r@3k -> context x4
per sort) and the positional-rank invariant are unchanged from core.fast;
results are bit-identical (tested against the golden model and the v1 path).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.scan import blocked_cummax
from .doubling import SENT_LARGE, SENT_SMALL, _invert_permutation

_BIG = jnp.int32(0x7FFFFFFF)
_EXT_BASE = 512

def _sort_ctx(keys, iota, payloads):
    """Lexicographic sort by (*keys, iota), permuting payloads along.

    The sort HLO, full stop: XLA picks the device's sort implementation.
    Whether a hand-written packed-key sort would beat it on these 5-6
    operand sorts is an open question for a device trace."""
    ops = tuple(keys) + (iota,) + tuple(payloads)
    return list(lax.sort(ops, num_keys=len(keys)))


def _bootstrap_round(data: jnp.ndarray, sentinel: str):
    """First sort straight off the text: four packed-trigram keys at offsets
    0,3,6,9 give context 12 in ONE 4-key sort — replacing v1's separate
    order-3 init (a full sort + inversion) entirely.

    Trigrams use the 9-bit extended-symbol space (byte b -> b+1, off-end pad
    0 or 511) so short suffixes order correctly vs embedded 0x00/0xFF bytes;
    raw-byte packing would leave end-adjacent suffix pairs permanently tied
    (both read the off-end rank sentinel at every later offset)."""
    n = data.shape[0]
    iota = lax.iota(jnp.int32, n)
    ext = data.astype(jnp.int32) + 1
    pad_val = jnp.int32(0 if sentinel == SENT_SMALL else _EXT_BASE - 1)
    extp = jnp.concatenate([ext, jnp.full((11,), pad_val, jnp.int32)])
    p27 = (
        extp[: n + 9] * (_EXT_BASE * _EXT_BASE)
        + extp[1 : n + 10] * _EXT_BASE
        + extp[2 : n + 11]
    )

    def key(j):
        return lax.slice(p27, (3 * j,), (3 * j + n,))

    k0, k1, k2, k3 = key(0), key(1), key(2), key(3)
    k0_s, k1_s, k2_s, k3_s, sorted_idx = lax.sort((k0, k1, k2, k3, iota), num_keys=4)
    head = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (k0_s[1:] != k0_s[:-1])
            | (k1_s[1:] != k1_s[:-1])
            | (k2_s[1:] != k2_s[:-1])
            | (k3_s[1:] != k3_s[:-1]),
        ]
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota, 0))
    rank = _invert_permutation(sorted_idx, ranks_sorted)
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), jnp.bool_)])
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32))
    return rank, nactive, sorted_idx, ranks_sorted, active_s


def _round_full_c(rank: jnp.ndarray, k, sentinel: str):
    """Full-width quadrupling round; also returns the round's own sorted
    order and active flags so a following compaction needs no re-sort."""
    n = rank.shape[0]
    iota = lax.iota(jnp.int32, n)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    padded = jnp.concatenate([rank, jnp.full((n,), off_end, jnp.int32)])

    def shifted(j):
        sl = lax.dynamic_slice(padded, (jnp.minimum(j * k, n),), (n,))
        return jnp.where(iota + j * k < n, sl, off_end)

    r1, r2, r3 = shifted(1), shifted(2), shifted(3)
    r0_s, r1_s, r2_s, r3_s, sorted_idx = lax.sort((rank, r1, r2, r3, iota), num_keys=4)
    head = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (r0_s[1:] != r0_s[:-1])
            | (r1_s[1:] != r1_s[:-1])
            | (r2_s[1:] != r2_s[:-1])
            | (r3_s[1:] != r3_s[:-1]),
        ]
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota, 0))
    new_rank = _invert_permutation(sorted_idx, ranks_sorted)
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), jnp.bool_)])
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32))
    return new_rank, nactive, sorted_idx, ranks_sorted, active_s


def _compact_from_round(sorted_idx, ranks_sorted, active_s, cap: int):
    """Active (position, group-head-rank) pairs from a round's sorted order.

    One full-width sort (actives to the front) replaces v1's two."""
    n = sorted_idx.shape[0]
    key = jnp.where(active_s, jnp.int32(0), jnp.int32(1))
    _, apos, ar0 = lax.sort((key, sorted_idx, ranks_sorted), num_keys=1)
    nact = jnp.sum(active_s.astype(jnp.int32))
    keep = lax.iota(jnp.int32, cap) < nact
    return (
        jnp.where(keep, apos[:cap], jnp.int32(-1)),
        jnp.where(keep, ar0[:cap], _BIG),
    )


def _round_active_c(rank, apos, ar0, k, sentinel: str):
    """Narrowed quadrupling round over C actives, carrying r0 (3 gathers)."""
    n = rank.shape[0]
    C = apos.shape[0]
    iota_c = lax.iota(jnp.int32, C)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    valid = apos >= 0
    safe = jnp.where(valid, apos, 0)

    def shifted(j):
        p = safe + j * k
        ok = valid & (p < n)
        return jnp.where(ok, rank[jnp.minimum(p, n - 1)], off_end)

    r1, r2, r3 = shifted(1), shifted(2), shifted(3)
    r0 = jnp.where(valid, ar0, _BIG)
    pos_key = jnp.where(valid, apos, jnp.int32(-1))
    r0_s, r1_s, r2_s, r3_s, pos_s = lax.sort((r0, r1, r2, r3, pos_key), num_keys=4)

    one = jnp.ones((1,), jnp.bool_)
    h0 = jnp.concatenate([one, r0_s[1:] != r0_s[:-1]])
    h4 = h0 | jnp.concatenate(
        [one, (r1_s[1:] != r1_s[:-1]) | (r2_s[1:] != r2_s[:-1]) | (r3_s[1:] != r3_s[:-1])]
    )
    t0 = lax.cummax(jnp.where(h0, iota_c, 0))
    t4 = lax.cummax(jnp.where(h4, iota_c, 0))
    new_rank_s = r0_s + (t4 - t0)

    pad = pos_s < 0
    nxt_h4 = jnp.concatenate([h4[1:], one])
    still = jnp.logical_not(h4 & nxt_h4) & jnp.logical_not(pad)

    new_rank_s = jnp.where(pad, jnp.int32(0), new_rank_s)
    upd_pos = jnp.where(pad, jnp.int32(n), pos_s)
    rank = rank.at[upd_pos].set(new_rank_s, mode="drop")

    # compact still-active (pos, r0) to the front for the next round
    key = jnp.where(still, jnp.int32(0), jnp.int32(1))
    _, new_apos, new_ar0 = lax.sort(
        (key, jnp.where(still, pos_s, jnp.int32(-1)), new_rank_s), num_keys=1
    )
    nactive = jnp.sum(still.astype(jnp.int32))
    keep = iota_c < nactive
    return (
        rank,
        jnp.where(keep, new_apos, jnp.int32(-1)),
        jnp.where(keep, new_ar0, _BIG),
        nactive,
    )


def _narrow_caps(n: int):
    cap1 = max(min(n, 4096), n // 16)
    cap2 = max(min(n, 4096), n // 256)
    cap3 = min(n, 4096)
    return cap1, cap2, cap3


def _recompact(apos, ar0, na, cap_to: int):
    """Re-compact an active set to a smaller capacity (C-width sort)."""
    keyc = jnp.where(apos >= 0, jnp.int32(0), jnp.int32(1))
    _, aposc, ar0c = lax.sort((keyc, apos, ar0), num_keys=1)
    keep = lax.iota(jnp.int32, cap_to) < na
    return (
        jnp.where(keep, aposc[:cap_to], jnp.int32(-1)),
        jnp.where(keep, ar0c[:cap_to], _BIG),
    )


def _narrow_cascade(rank, k, na, apos, ar0, sentinel: str, caps):
    """Run narrowed rounds at progressively smaller static capacities.

    caps = (cap1, cap2, cap3, ...): rounds run at cap_i while the active
    count exceeds cap_{i+1} (to completion at the last), re-compacting
    between stages.  Tiny residues (e.g. 12 stragglers at 2^26) thus pay
    ~4096-wide rounds, not n/256-wide ones."""
    n = rank.shape[0]

    def stage(carry, cap: int, next_cap: int | None):
        k, rank, apos, ar0, na = carry

        def cond(state):
            k, rank, apos, ar0, na = state
            more = (na > next_cap) if next_cap is not None else (na > 0)
            return more & (na > 0) & (k < n)

        def body(state):
            k, rank, apos, ar0, _ = state
            rank, apos, ar0, na = _round_active_c(rank, apos, ar0, k, sentinel)
            return k * 4, rank, apos, ar0, na

        return lax.while_loop(cond, body, (k, rank, apos, ar0, na))

    carry = (k, rank, apos, ar0, na)
    for i, cap in enumerate(caps):
        next_cap = caps[i + 1] if i + 1 < len(caps) else None
        if i > 0:
            def shrink(c, cap=cap):
                k, rank, apos, ar0, na = c
                apos, ar0 = _recompact(apos, ar0, na, cap)
                return k, rank, apos, ar0, na

            def keep(c, cap=cap):
                k, rank, apos, ar0, na = c
                return (
                    k,
                    rank,
                    jnp.full((cap,), jnp.int32(-1)),
                    jnp.full((cap,), _BIG),
                    na,
                )

            k0, rank0, apos0_, ar00, na0 = carry
            carry = lax.cond(na0 > 0, shrink, keep, carry)
        carry = lax.cond(
            (carry[4] > 0) & (carry[0] < n),
            lambda c, cap=cap, nc=next_cap: stage(c, cap, nc),
            lambda c: c,
            carry,
        )
    k, rank, _, _, na = carry
    return k, rank, na


def _ranks_loop(boot_state, k0: int, n: int, sentinel: str) -> jnp.ndarray:
    """Shared back half of the rank pipelines: full-width quadrupling rounds
    while actives > n/16, then the narrowed cascade.  ``boot_state`` is a
    bootstrap round's (rank, nactive, sorted_idx, ranks_sorted, active_s);
    ``k0`` is the context the bootstrap already covers."""
    cap1, cap2, cap3 = _narrow_caps(n)
    rank, nactive, si, rs, ac = boot_state

    def full_cond(state):
        k, rank, na, _si, _rs, _ac = state
        return (na * 16 > n) & (na > 0) & (k < n)

    def full_body(state):
        k, rank, _, _, _, _ = state
        new_rank, na, si, rs, ac = _round_full_c(rank, k, sentinel)
        return k * 4, new_rank, na, si, rs, ac

    k, rank, nactive, si, rs, ac = lax.while_loop(
        full_cond, full_body, (jnp.int32(k0), rank, nactive, si, rs, ac)
    )

    # --- narrowed cascade (compaction reuses the last round's order)
    def narrowed(args):
        k, rank, na, si, rs, ac = args
        apos, ar0 = _compact_from_round(si, rs, ac, cap1)
        k, rank, na = _narrow_cascade(
            rank, k, na, apos, ar0, sentinel, (cap1, cap2, cap3)
        )
        return k, rank, na

    k, rank, nactive = lax.cond(
        (nactive > 0) & (k < n),
        narrowed,
        lambda a: (a[0], a[1], a[2]),
        (k, rank, nactive, si, rs, ac),
    )
    return rank


def _ranks_impl(data: jnp.ndarray, sentinel: str) -> jnp.ndarray:
    n = data.shape[0]
    # bootstrap: context 12 in one 4-key sort (no separate init)
    return _ranks_loop(_bootstrap_round(data, sentinel), 12, n, sentinel)


def _bootstrap_window_round(win: jnp.ndarray, w: int, sentinel: str):
    """Bootstrap from caller-supplied window keys: ``win[x]`` is an
    order-consistent comparison key for ``w`` underlying positions starting
    at x.  Four keys at offsets 0,w,2w,3w give context 4w in one sort —
    the generalization the a6 bit path seeds its 16-bit windows through."""
    m = win.shape[0]
    iota = lax.iota(jnp.int32, m)
    off = jnp.int32(-1) if sentinel == SENT_SMALL else _BIG
    winp = jnp.concatenate([win.astype(jnp.int32), jnp.full((3 * w,), off, jnp.int32)])

    def key(j):
        return lax.slice(winp, (j * w,), (j * w + m,))

    k0_s, k1_s, k2_s, k3_s, sorted_idx = lax.sort(
        (key(0), key(1), key(2), key(3), iota), num_keys=4
    )
    head = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (k0_s[1:] != k0_s[:-1])
            | (k1_s[1:] != k1_s[:-1])
            | (k2_s[1:] != k2_s[:-1])
            | (k3_s[1:] != k3_s[:-1]),
        ]
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota, 0))
    rank = _invert_permutation(sorted_idx, ranks_sorted)
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), jnp.bool_)])
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32))
    return rank, nactive, sorted_idx, ranks_sorted, active_s


@functools.partial(jax.jit, static_argnames=("w", "sentinel"))
def suffix_ranks_windows(
    win: jnp.ndarray, w: int, sentinel: str = SENT_SMALL
) -> jnp.ndarray:
    """Rank array of the implicit string whose order-``w`` context keys are
    ``win`` (int32), via the full measurement-tuned pipeline (quadrupling
    rounds, narrowed cascade).  The caller owns the window construction and
    its tail semantics; reads past the end use the sentinel convention."""
    m = win.shape[0]
    if m <= 1:
        return jnp.zeros((m,), jnp.int32)
    return _ranks_loop(
        _bootstrap_window_round(win, w, sentinel), 4 * w, m, sentinel
    )


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_ranks_v2(data: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """Rank array (inverse SA) of ``data`` (uint8), one fused jit."""
    n = data.shape[0]
    if n <= 1:
        return jnp.zeros((n,), jnp.int32)
    return _ranks_impl(data, sentinel)


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_array_v2(data: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    n = data.shape[0]
    if n <= 1:
        return jnp.zeros((n,), jnp.int32)
    rank = _ranks_impl(data, sentinel)
    return _invert_permutation(rank, lax.iota(jnp.int32, n))


def _trigram_keys(data: jnp.ndarray, sentinel: str) -> jnp.ndarray:
    """Packed-trigram key per position (length n+9): p27[x] is an order-
    consistent context-3 comparison key for the suffix at x, in the 9-bit
    extended-symbol space (byte b -> b+1, off-end pad 0 or 511)."""
    n = data.shape[0]
    ext = data.astype(jnp.int32) + 1
    pad_val = jnp.int32(0 if sentinel == SENT_SMALL else _EXT_BASE - 1)
    extp = jnp.concatenate([ext, jnp.full((11,), pad_val, jnp.int32)])
    return (
        extp[: n + 9] * (_EXT_BASE * _EXT_BASE)
        + extp[1 : n + 10] * _EXT_BASE
        + extp[2 : n + 11]
    )


def _bootstrap_sorted(data: jnp.ndarray, prev: jnp.ndarray, sentinel: str):
    """Bootstrap WITHOUT the rank inversion: returns the sorted-order state
    (sorted_idx, ranks_sorted, active flags, nactive, prev_sorted)."""
    n = data.shape[0]
    iota = lax.iota(jnp.int32, n)
    p27 = _trigram_keys(data, sentinel)

    def key(j):
        return lax.slice(p27, (3 * j,), (3 * j + n,))

    k0_s, k1_s, k2_s, k3_s, sorted_idx, prev_s = _sort_ctx(
        (key(0), key(1), key(2), key(3)), iota, (prev,)
    )
    head = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (k0_s[1:] != k0_s[:-1])
            | (k1_s[1:] != k1_s[:-1])
            | (k2_s[1:] != k2_s[:-1])
            | (k3_s[1:] != k3_s[:-1]),
        ]
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota, 0))
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), jnp.bool_)])
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32))
    return sorted_idx, ranks_sorted, active_s, nactive, prev_s


def _round_full_sorted(si, rs, prev, k, sentinel: str):
    """Full round taking the PREVIOUS round's sorted-order state: performs
    the deferred rank inversion at its top, then the 4-key sort carrying
    (iota, prev) payloads.  Lets the caller skip the final inversion + the
    separate emission sort entirely when the input resolves inside the
    full-round loop (the common case for text).

    Also returns the inverted rank it computed (context k/4, position-
    indexed): the caller carries it as the consistent coarse snapshot the
    inversion-free micro tail refines against (see ``_micro_round``)."""
    n = si.shape[0]
    iota = lax.iota(jnp.int32, n)
    rank = _invert_permutation(si, rs)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    padded = jnp.concatenate([rank, jnp.full((n,), off_end, jnp.int32)])

    def shifted(j):
        sl = lax.dynamic_slice(padded, (jnp.minimum(j * k, n),), (n,))
        return jnp.where(iota + j * k < n, sl, off_end)

    r1, r2, r3 = shifted(1), shifted(2), shifted(3)
    r0_s, r1_s, r2_s, r3_s, sorted_idx, prev_s = _sort_ctx(
        (rank, r1, r2, r3), iota, (prev,)
    )
    head = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (r0_s[1:] != r0_s[:-1])
            | (r1_s[1:] != r1_s[:-1])
            | (r2_s[1:] != r2_s[:-1])
            | (r3_s[1:] != r3_s[:-1]),
        ]
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota, 0))
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), jnp.bool_)])
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32))
    return sorted_idx, ranks_sorted, active_s, nactive, prev_s, rank


_TILE = 32


def _extract_actives_sorted(si, rs, ac, na, cap: int):
    """Entry-active (position, group-head-rank) pairs when ``na <= cap``,
    WITHOUT a full-width compaction sort.

    Actives are flagged in the round's own sorted order; tie groups are
    contiguous runs there, so with 32-wide tiles at most ``na`` tiles hold
    actives (each active tile holds >= 1 active).  Reduce per tile, sort
    only the n/32 tile keys, gather the first ``cap`` candidate tiles, and
    compact at cap*32 width — far narrower than a full-width sort."""
    n = si.shape[0]
    if n <= cap * _TILE:
        return _compact_from_round(si, rs, ac, cap)
    T = -(-n // _TILE)
    pad = T * _TILE - n
    if pad:
        ac = jnp.concatenate([ac, jnp.zeros((pad,), jnp.bool_)])
        si = jnp.concatenate([si, jnp.full((pad,), jnp.int32(-1))])
        rs = jnp.concatenate([rs, jnp.full((pad,), _BIG)])
    ac2, si2, rs2 = (x.reshape(T, _TILE) for x in (ac, si, rs))
    tkey = jnp.logical_not(jnp.any(ac2, axis=1)).astype(jnp.int32)
    _, tidx = lax.sort((tkey, lax.iota(jnp.int32, T)), num_keys=1)
    tidx = tidx[:cap]
    g_ac = ac2[tidx].reshape(-1)
    g_si = si2[tidx].reshape(-1)
    g_rs = rs2[tidx].reshape(-1)
    key = jnp.where(g_ac, jnp.int32(0), jnp.int32(1))
    _, apos, ar0 = lax.sort(
        (key, jnp.where(g_ac, g_si, jnp.int32(-1)), g_rs), num_keys=1
    )
    keep = lax.iota(jnp.int32, cap) < na
    return (
        jnp.where(keep, apos[:cap], jnp.int32(-1)),
        jnp.where(keep, ar0[:cap], _BIG),
    )


def _micro_round(G, g, pos, r, j_lo: int, j_hi: int, sentinel: str):
    """Inversion-free narrowed round over C actives.

    Refines current ranks ``r`` (context j_lo*g, group-head convention) to
    context j_hi*g by sorting on (r, G[p+j_lo*g], G[p+(j_lo+1)*g], ...,
    G[p+(j_hi-1)*g]): ``G`` is any position-indexed, order-consistent
    granule-``g`` key array — the PREVIOUS full round's rank snapshot, or
    the packed-trigram keys when no full round ran.  Consecutive granule-g
    keys chain contexts exactly like a doubling step, but need NO final
    full-width rank inversion and NO scatter updates (all reads come from
    the one consistent snapshot).  Entries are never compacted: resolved
    ones ride along idempotently, so every entry's final refined rank
    survives to the emission correction."""
    n = G.shape[0]
    C = pos.shape[0]
    iota_c = lax.iota(jnp.int32, C)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else _BIG
    valid = pos >= 0
    safe = jnp.where(valid, pos, 0)
    keys = [jnp.where(valid, r, _BIG)]
    for j in range(j_lo, j_hi):
        p = safe + j * g
        ok = valid & (p < n)
        keys.append(jnp.where(ok, G[jnp.minimum(p, n - 1)], off_end))
    sorted_ops = lax.sort(
        tuple(keys) + (jnp.where(valid, pos, jnp.int32(-1)),),
        num_keys=len(keys),
    )
    ks, pos_s = sorted_ops[:-1], sorted_ops[-1]
    one = jnp.ones((1,), jnp.bool_)
    h0 = jnp.concatenate([one, ks[0][1:] != ks[0][:-1]])
    rest = jnp.zeros((C - 1,), jnp.bool_)
    for kk in ks[1:]:
        rest = rest | (kk[1:] != kk[:-1])
    hF = h0 | jnp.concatenate([one, rest])
    t0 = lax.cummax(jnp.where(h0, iota_c, 0))
    tF = lax.cummax(jnp.where(hF, iota_c, 0))
    pad = pos_s < 0
    r_new = jnp.where(pad, _BIG, ks[0] + (tF - t0))
    nxt = jnp.concatenate([hF[1:], one])
    still = jnp.logical_not(hF & nxt) & jnp.logical_not(pad)
    return pos_s, r_new, jnp.sum(still.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_v3(data: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Forward BWT with deferred inversions: returns (L, base) only.

    Structure: bootstrap (context 12, no inversion) -> full rounds whose
    rank inversion happens at the TOP of the next round, with the
    previous-byte payload riding along every sort.  When the text resolves
    within the full-round loop (nactive == 0), L is the carried payload and
    base = argmax(sorted_idx == 0) — no final inversion, no emission sort.

    Otherwise a small residue (<= 4096 actives) takes the INVERSION-FREE
    micro tail: tile-extract the actives from the round's own sorted order
    and refine them against the carried coarse rank snapshot G (two static
    multi-key rounds covering context k..16k) — no full-width sort at all,
    vs the two full-width sorts the cascade entry costs.
    Only large residues (or >16k-deep ties, e.g. long exact periodicity)
    pay the full narrowed cascade."""
    n = data.shape[0]
    if n <= 1:
        return data, jnp.int32(0)
    return _bwt_v3_impl(data, jnp.roll(data, 1), sentinel)


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_v3_payload(data: jnp.ndarray, payload: jnp.ndarray,
                   sentinel: str = SENT_SMALL):
    """``bwt_v3`` with a caller-supplied carried payload: returns (L, base)
    with L[rank[p]] = payload[p].  ``bwt_v3`` is the special case
    payload = roll(data, 1).  This is the a6 port's entry: a6 sorts the
    RECODED reversed symbol string but must emit the
    next ORIGINAL byte, so its payload lives in a different alphabet than
    its sort keys — the structure (deferred inversions, carried payload,
    micro tail) is identical.  Ref: the reference couples the two the same
    way, emitting decoded symbols while sorting recoded keys
    (a6/src/bwt.c:303-335 vs :349-439)."""
    n = data.shape[0]
    if n <= 1:
        return payload, jnp.int32(0)
    return _bwt_v3_impl(data, payload, sentinel)


def _bwt_v3_impl(data: jnp.ndarray, prev: jnp.ndarray, sentinel: str):
    n = data.shape[0]
    cap1, cap2, cap3 = _narrow_caps(n)

    si, rs, ac, na, prev_s = _bootstrap_sorted(data, prev, sentinel)
    # G: position-indexed granule-(k/4) consistent keys. At bootstrap exit
    # that's the packed-trigram array (context 3 = 12/4); after R full
    # rounds it's the context-k/4 rank snapshot the round inverted anyway.
    G0 = _trigram_keys(data, sentinel)[:n]

    def full_cond(state):
        k, si, rs, ac, na, prev_s, G = state
        return (na * 16 > n) & (na > 0) & (k < n)

    def full_body(state):
        k, si, rs, ac, na, prev_s, G = state
        si, rs, ac, na, prev_s, rank = _round_full_sorted(si, rs, prev, k, sentinel)
        return k * 4, si, rs, ac, na, prev_s, rank

    k, si, rs, ac, na, prev_s, G = lax.while_loop(
        full_cond, full_body, (jnp.int32(12), si, rs, ac, na, prev_s, G0)
    )

    # Resolved-inside-the-loop fast exit: at production block sizes text
    # usually resolves within the full rounds (BASELINE.md tie profile:
    # 0.00 tied at ctx 48), so the micro tail's extraction + refinement
    # sorts would run for nothing on the common path.  The tail sits
    # behind na == 0.  (The batched twin keeps a flat tail instead; see
    # core/batched.py.)
    def emit_direct(args):
        k, si, rs, ac, na, prev_s = args
        b_slot = jnp.argmax(si == 0).astype(jnp.int32)
        return prev_s, rs[b_slot]

    def tail_path(args):
        k, si, rs, ac, na, prev_s = args
        apos_m, ar0_m = _extract_actives_sorted(si, rs, ac, na, cap3)
        g = jnp.maximum(k // 4, 1)
        pos1, r1m, _na1 = _micro_round(G, g, apos_m, ar0_m, 4, 16, sentinel)
        mpos, mr, mna = _micro_round(G, g, pos1, r1m, 16, 64, sentinel)
        micro_done = (na <= cap3) & (mna == 0)

        def emit_micro(args):
            """Scatter-correct the carried payload at the refined actives."""
            k, si, rs, ac, na, prev_s, pos, r = args
            valid = pos >= 0
            safe = jnp.where(valid, pos, 0)
            tgt = jnp.where(valid, r, jnp.int32(n))
            L = prev_s.at[tgt].set(prev[safe], mode="drop")
            b_slot = jnp.argmax(si == 0).astype(jnp.int32)
            base = jnp.maximum(
                rs[b_slot],
                jnp.max(jnp.where(valid & (pos == 0), r, jnp.int32(-1))),
            )
            return L, base

        def cascade_path(args):
            k, si, rs, ac, na, prev_s, pos, r = args
            rank = _invert_permutation(si, rs)
            apos, ar0 = _compact_from_round(si, rs, ac, cap1)
            apos0 = apos  # entry actives: only their slots' payload can move

            k, rank, na2 = _narrow_cascade(
                rank, k, na, apos, ar0, sentinel, (cap1, cap2, cap3)
            )

            # Resolved suffixes' ranks never moved (positional-rank
            # invariant), so prev_s is correct everywhere except the entry
            # actives: scatter-correct just those slots.
            safe0 = jnp.where(apos0 >= 0, apos0, 0)
            final_r = jnp.where(apos0 >= 0, rank[safe0], jnp.int32(n))
            L = prev_s.at[final_r].set(prev[safe0], mode="drop")
            return L, rank[0]

        return lax.cond(
            micro_done,
            emit_micro,
            cascade_path,
            (k, si, rs, ac, na, prev_s, mpos, mr),
        )

    return lax.cond(
        na == 0,
        emit_direct,
        tail_path,
        (k, si, rs, ac, na, prev_s),
    )


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_forward_v2(data: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Forward BWT via the v2 sorter with sort-based emission.

    L[rank[p]] = data[(p-1) mod n] realized as one 1-key sort with a u8
    payload instead of a random scatter.  Returns (L, base, rank)."""
    n = data.shape[0]
    rank = suffix_ranks_v2(data, sentinel)
    prev = jnp.roll(data, 1)
    _, L = lax.sort((rank, prev), num_keys=1)
    base = rank[0]
    return L, base, rank


def suffix_array_fast2(data, sentinel: str = SENT_SMALL):
    """Host convenience wrapper (numpy in/out)."""
    arr = (
        jnp.asarray(np.frombuffer(bytes(data), np.uint8))
        if not isinstance(data, (jnp.ndarray, np.ndarray))
        else jnp.asarray(data, dtype=jnp.uint8)
    )
    return np.asarray(suffix_array_v2(arr, sentinel))
