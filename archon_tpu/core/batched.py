"""Batched (block-parallel) suffix sorting: many blocks in one fused jit.

The reference's production compressors are *block-streaming*: x1 fixes 4 MiB
blocks (final/x1/ArchonX1.c:19,53-60), x2/x3 take ``-b`` and transform each
block independently (final/x2/ArchonX2.c:87-107, final/x3/archon.c:119-143).
That framing is the natural accelerator batch axis: ``lax.sort`` sorts along
the last axis, so a (B, nb) array is B independent sorts in ONE kernel
launch, and every block shares the same doubling schedule
``k = 3, 12, 48, ...`` so the whole batch runs under a single fused
while_loop with scalar ``k``.

This module is the 2D generalization of ``core.fast`` (same invariants:
positional ranks, active-set narrowing, zero mid-compute host syncs).  A
hand-written batch beats ``jax.vmap`` over the 1D path because vmap would
lift the per-block loop counters into per-element dynamic-slice starts
(degrading contiguous shifts into gathers); here ``k`` stays scalar.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.scan import blocked_cummax
from .doubling import SENT_LARGE, SENT_SMALL

_EXT_BASE = 512


def _row_iota(B: int, n: int):
    return jnp.broadcast_to(lax.iota(jnp.int32, n), (B, n))


def _positional_ranks2(head: jnp.ndarray, iota2: jnp.ndarray):
    """Per-row rank-by-sorted-slot: position of the group head."""
    return blocked_cummax(jnp.where(head.astype(bool), iota2, 0))


def _actives_from_heads2(head: jnp.ndarray):
    nxt = jnp.concatenate(
        [head[:, 1:], jnp.ones_like(head[:, :1])], axis=1
    )
    return jnp.logical_not(head.astype(bool) & nxt.astype(bool))


def _invert_rows(perm: jnp.ndarray, values: jnp.ndarray):
    """Per-row permutation inversion via sort instead of a random scatter."""
    _, out = lax.sort((perm, values), num_keys=1, dimension=1)
    return out


def _init2(data2: jnp.ndarray, sentinel: str):
    """Order-3 initial ranks per row.  data2: (B, n) uint8."""
    B, n = data2.shape
    iota2 = _row_iota(B, n)
    ext = data2.astype(jnp.int32) + 1
    pad_val = jnp.int32(0 if sentinel == SENT_SMALL else _EXT_BASE - 1)
    extp = jnp.concatenate([ext, jnp.full((B, 2), pad_val, jnp.int32)], axis=1)
    packed = (
        extp[:, :n] * (_EXT_BASE * _EXT_BASE)
        + extp[:, 1 : n + 1] * _EXT_BASE
        + extp[:, 2 : n + 2]
    )
    sorted_keys, sorted_idx = lax.sort((packed, iota2), num_keys=1, dimension=1)
    head = jnp.concatenate(
        [
            jnp.ones((B, 1), jnp.int32),
            (sorted_keys[:, 1:] != sorted_keys[:, :-1]).astype(jnp.int32),
        ],
        axis=1,
    )
    ranks_sorted = _positional_ranks2(head, iota2)
    rank = _invert_rows(sorted_idx, ranks_sorted)
    active = _actives_from_heads2(head)
    return rank, jnp.sum(active.astype(jnp.int32), axis=1)


def _shifted2(padded: jnp.ndarray, iota2: jnp.ndarray, n: int, k, off_end):
    """rank[:, i+k] with off-end sentinel (contiguous per-row slice)."""
    sl = lax.dynamic_slice_in_dim(padded, jnp.minimum(k, n), n, axis=1)
    return jnp.where(iota2 + k < n, sl, off_end)


def _round_full2(rank: jnp.ndarray, k, sentinel: str):
    B, n = rank.shape
    iota2 = _row_iota(B, n)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    padded = jnp.concatenate([rank, jnp.full((B, n), off_end, jnp.int32)], axis=1)
    r1 = _shifted2(padded, iota2, n, k, off_end)
    r2 = _shifted2(padded, iota2, n, 2 * k, off_end)
    r3 = _shifted2(padded, iota2, n, 3 * k, off_end)
    r0_s, r1_s, r2_s, r3_s, sorted_idx = lax.sort(
        (rank, r1, r2, r3, iota2), num_keys=4, dimension=1
    )
    head = jnp.concatenate(
        [
            jnp.ones((B, 1), jnp.int32),
            (
                (r0_s[:, 1:] != r0_s[:, :-1])
                | (r1_s[:, 1:] != r1_s[:, :-1])
                | (r2_s[:, 1:] != r2_s[:, :-1])
                | (r3_s[:, 1:] != r3_s[:, :-1])
            ).astype(jnp.int32),
        ],
        axis=1,
    )
    ranks_sorted = _positional_ranks2(head, iota2)
    new_rank = _invert_rows(sorted_idx, ranks_sorted)
    active = _actives_from_heads2(head)
    return new_rank, jnp.sum(active.astype(jnp.int32), axis=1)


def _compact2(rank: jnp.ndarray, cap: int):
    """Per-row active positions (non-singleton groups), -1-padded to cap."""
    B, n = rank.shape
    iota2 = _row_iota(B, n)
    r_s, idx_s = lax.sort((rank, iota2), num_keys=1, dimension=1)
    head = jnp.concatenate(
        [jnp.ones((B, 1), jnp.int32), (r_s[:, 1:] != r_s[:, :-1]).astype(jnp.int32)],
        axis=1,
    )
    active = _actives_from_heads2(head)
    key = jnp.where(active, jnp.int32(0), jnp.int32(1))
    _, pos = lax.sort((key, idx_s), num_keys=1, dimension=1)
    nact = jnp.sum(active.astype(jnp.int32), axis=1, keepdims=True)
    out = jnp.where(_row_iota(B, cap) < nact, pos[:, :cap], jnp.int32(-1))
    return out


def _take_rows(arr2: jnp.ndarray, idx2: jnp.ndarray):
    return jnp.take_along_axis(arr2, idx2, axis=1)


def _round_active2(rank: jnp.ndarray, apos: jnp.ndarray, k, sentinel: str):
    """Refine only active positions per row (capacity C = apos.shape[1])."""
    B, n = rank.shape
    C = apos.shape[1]
    iota_c = _row_iota(B, C)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    valid = apos >= 0
    safe = jnp.where(valid, apos, 0)
    BIG = jnp.int32(0x7FFFFFFF)

    r0 = jnp.where(valid, _take_rows(rank, safe), BIG)

    def shifted(j):
        p = safe + j * k
        ok = valid & (p < n)
        return jnp.where(ok, _take_rows(rank, jnp.minimum(p, n - 1)), off_end)

    r1, r2, r3 = shifted(1), shifted(2), shifted(3)
    pos_key = jnp.where(valid, apos, jnp.int32(-1))
    r0_s, r1_s, r2_s, r3_s, pos_s = lax.sort(
        (r0, r1, r2, r3, pos_key), num_keys=4, dimension=1
    )

    ones = jnp.ones((B, 1), jnp.bool_)
    h0 = jnp.concatenate([ones, r0_s[:, 1:] != r0_s[:, :-1]], axis=1)
    h4 = h0 | jnp.concatenate(
        [
            ones,
            (r1_s[:, 1:] != r1_s[:, :-1])
            | (r2_s[:, 1:] != r2_s[:, :-1])
            | (r3_s[:, 1:] != r3_s[:, :-1]),
        ],
        axis=1,
    )
    t0 = lax.cummax(jnp.where(h0, iota_c, 0), axis=1)
    t4 = lax.cummax(jnp.where(h4, iota_c, 0), axis=1)
    new_rank_s = r0_s + (t4 - t0)

    pad = pos_s < 0
    nxt_h4 = jnp.concatenate([h4[:, 1:], ones], axis=1)
    still = jnp.logical_not(h4 & nxt_h4) & jnp.logical_not(pad)

    new_rank_s = jnp.where(pad, jnp.int32(0), new_rank_s)
    upd_pos = jnp.where(pad, jnp.int32(n), pos_s)  # n = out of bounds -> drop
    rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, C))
    rank = rank.at[rows, upd_pos].set(new_rank_s, mode="drop")

    key = jnp.where(still, jnp.int32(0), jnp.int32(1))
    _, new_apos = lax.sort(
        (key, jnp.where(still, pos_s, jnp.int32(-1))), num_keys=1, dimension=1
    )
    nactive = jnp.sum(still.astype(jnp.int32), axis=1)
    new_apos = jnp.where(iota_c < nactive[:, None], new_apos, jnp.int32(-1))
    return rank, new_apos, nactive


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_ranks_batched(data2: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """Rank arrays (inverse SAs) of every row of (B, n) uint8, fully fused.

    Same three-phase structure as core.fast.suffix_ranks_fused — full
    quadrupling rounds while >1/4 of any block's suffixes are tied, then
    narrowed rounds at capacity n/4 and n/32 — but with all blocks advancing
    in lockstep under one scalar ``k``.  Blocks that finish early ride along
    idempotently (their rounds are no-ops by the positional-rank invariant).
    """
    B, n = data2.shape
    if n <= 1:
        return jnp.zeros((B, n), jnp.int32)
    rank, nactive = _init2(data2, sentinel)

    def full_cond(state):
        k, rank, na = state
        return (jnp.max(na) * 4 > n) & (jnp.max(na) > 0) & (k < n)

    def full_body(state):
        k, rank, _ = state
        new_rank, na = _round_full2(rank, k, sentinel)
        return k * 4, new_rank, na

    k, rank, nactive = lax.while_loop(
        full_cond, full_body, (jnp.int32(3), rank, nactive)
    )

    def narrowed_stage(k, rank, nactive, cap, stop_den):
        def run(args):
            k, rank, na = args
            apos = _compact2(rank, cap)

            def cond(state):
                k, rank, apos, na = state
                more = (jnp.max(na) * stop_den > n) if stop_den else (jnp.max(na) > 0)
                return more & (jnp.max(na) > 0) & (k < n)

            def body(state):
                k, rank, apos, _ = state
                rank, apos, na = _round_active2(rank, apos, k, sentinel)
                return k * 4, rank, apos, na

            k, rank, _, na = lax.while_loop(cond, body, (k, rank, apos, na))
            return k, rank, na

        return lax.cond(
            (jnp.max(nactive) > 0) & (k < n), run, lambda a: a, (k, rank, nactive)
        )

    cap1 = max(min(n, 4096), n // 4)
    cap2 = max(min(n, 4096), n // 32)
    k, rank, nactive = narrowed_stage(k, rank, nactive, cap1, 32)
    k, rank, nactive = narrowed_stage(k, rank, nactive, cap2, 0)
    return rank


def _trigram_keys2(data2: jnp.ndarray, sentinel: str) -> jnp.ndarray:
    """Per-row packed-trigram keys (B, n+9) — see fast2._trigram_keys."""
    B, n = data2.shape
    ext = data2.astype(jnp.int32) + 1
    pad_val = jnp.int32(0 if sentinel == SENT_SMALL else _EXT_BASE - 1)
    extp = jnp.concatenate([ext, jnp.full((B, 11), pad_val, jnp.int32)], axis=1)
    return (
        extp[:, : n + 9] * (_EXT_BASE * _EXT_BASE)
        + extp[:, 1 : n + 10] * _EXT_BASE
        + extp[:, 2 : n + 11]
    )


def _bootstrap_sorted2(data2: jnp.ndarray, prev2: jnp.ndarray, sentinel: str):
    """Per-row context-12 bootstrap (4 packed-trigram keys, one sort), no
    rank inversion — the 2D port of fast2._bootstrap_sorted."""
    B, n = data2.shape
    iota2 = _row_iota(B, n)
    p27 = _trigram_keys2(data2, sentinel)

    def key(j):
        return lax.slice_in_dim(p27, 3 * j, 3 * j + n, axis=1)

    k0_s, k1_s, k2_s, k3_s, sorted_idx, prev_s = lax.sort(
        (key(0), key(1), key(2), key(3), iota2, prev2), num_keys=4, dimension=1
    )
    head = jnp.concatenate(
        [
            jnp.ones((B, 1), jnp.bool_),
            (k0_s[:, 1:] != k0_s[:, :-1])
            | (k1_s[:, 1:] != k1_s[:, :-1])
            | (k2_s[:, 1:] != k2_s[:, :-1])
            | (k3_s[:, 1:] != k3_s[:, :-1]),
        ],
        axis=1,
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota2, 0))
    nxt = jnp.concatenate([head[:, 1:], jnp.ones((B, 1), jnp.bool_)], axis=1)
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32), axis=1)
    return sorted_idx, ranks_sorted, active_s, nactive, prev_s


def _round_full_sorted2(si, rs, prev2, k, sentinel: str):
    """2D full round with the deferred inversion at its top (fast2 port).
    Also returns the context-k/4 rank snapshot it inverted (carried by the
    caller as the micro tail's consistent coarse key array)."""
    B, n = si.shape
    iota2 = _row_iota(B, n)
    rank = _invert_rows(si, rs)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    padded = jnp.concatenate([rank, jnp.full((B, n), off_end, jnp.int32)], axis=1)
    r1 = _shifted2(padded, iota2, n, k, off_end)
    r2 = _shifted2(padded, iota2, n, 2 * k, off_end)
    r3 = _shifted2(padded, iota2, n, 3 * k, off_end)
    r0_s, r1_s, r2_s, r3_s, sorted_idx, prev_s = lax.sort(
        (rank, r1, r2, r3, iota2, prev2), num_keys=4, dimension=1
    )
    head = jnp.concatenate(
        [
            jnp.ones((B, 1), jnp.bool_),
            (r0_s[:, 1:] != r0_s[:, :-1])
            | (r1_s[:, 1:] != r1_s[:, :-1])
            | (r2_s[:, 1:] != r2_s[:, :-1])
            | (r3_s[:, 1:] != r3_s[:, :-1]),
        ],
        axis=1,
    )
    ranks_sorted = blocked_cummax(jnp.where(head, iota2, 0))
    nxt = jnp.concatenate([head[:, 1:], jnp.ones((B, 1), jnp.bool_)], axis=1)
    active_s = jnp.logical_not(head & nxt)
    nactive = jnp.sum(active_s.astype(jnp.int32), axis=1)
    return sorted_idx, ranks_sorted, active_s, nactive, prev_s, rank


_BIG = jnp.int32(0x7FFFFFFF)
_TILE = 32


def _extract_actives_sorted2(si, rs, ac, na, cap: int):
    """Per-row entry-active (pos, r0) pairs when every row's na <= cap,
    without a full-width compaction sort — 2D port of
    fast2._extract_actives_sorted (32-wide tiles, tile-key sort, tile
    gather, cap*32-wide compaction)."""
    B, n = si.shape
    if n <= cap * _TILE:
        return _compact_from_round2(si, rs, ac, cap)
    T = -(-n // _TILE)
    pad = T * _TILE - n
    if pad:
        ac = jnp.concatenate([ac, jnp.zeros((B, pad), jnp.bool_)], axis=1)
        si = jnp.concatenate([si, jnp.full((B, pad), jnp.int32(-1))], axis=1)
        rs = jnp.concatenate([rs, jnp.full((B, pad), _BIG)], axis=1)
    ac3, si3, rs3 = (x.reshape(B, T, _TILE) for x in (ac, si, rs))
    tkey = jnp.logical_not(jnp.any(ac3, axis=2)).astype(jnp.int32)
    _, tidx = lax.sort((tkey, _row_iota(B, T)), num_keys=1, dimension=1)
    tidx = tidx[:, :cap]
    g_ac = jnp.take_along_axis(ac3, tidx[:, :, None], axis=1).reshape(B, -1)
    g_si = jnp.take_along_axis(si3, tidx[:, :, None], axis=1).reshape(B, -1)
    g_rs = jnp.take_along_axis(rs3, tidx[:, :, None], axis=1).reshape(B, -1)
    key = jnp.where(g_ac, jnp.int32(0), jnp.int32(1))
    _, apos, ar0 = lax.sort(
        (key, jnp.where(g_ac, g_si, jnp.int32(-1)), g_rs), num_keys=1, dimension=1
    )
    keep = _row_iota(B, cap) < na[:, None]
    return (
        jnp.where(keep, apos[:, :cap], jnp.int32(-1)),
        jnp.where(keep, ar0[:, :cap], _BIG),
    )


def _micro_round2(G, g, pos, r, j_lo: int, j_hi: int, sentinel: str):
    """Per-row inversion-free narrowed round — 2D port of
    fast2._micro_round (sort on (r, G[p+j*g] for j in [j_lo, j_hi))
    against the consistent coarse snapshot G; no compaction)."""
    B, n = G.shape
    C = pos.shape[1]
    iota_c = _row_iota(B, C)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else _BIG
    valid = pos >= 0
    safe = jnp.where(valid, pos, 0)
    keys = [jnp.where(valid, r, _BIG)]
    for j in range(j_lo, j_hi):
        p = safe + j * g
        ok = valid & (p < n)
        keys.append(jnp.where(ok, _take_rows(G, jnp.minimum(p, n - 1)), off_end))
    sorted_ops = lax.sort(
        tuple(keys) + (jnp.where(valid, pos, jnp.int32(-1)),),
        num_keys=len(keys),
        dimension=1,
    )
    ks, pos_s = sorted_ops[:-1], sorted_ops[-1]
    ones = jnp.ones((B, 1), jnp.bool_)
    h0 = jnp.concatenate([ones, ks[0][:, 1:] != ks[0][:, :-1]], axis=1)
    rest = jnp.zeros((B, C - 1), jnp.bool_)
    for kk in ks[1:]:
        rest = rest | (kk[:, 1:] != kk[:, :-1])
    hF = h0 | jnp.concatenate([ones, rest], axis=1)
    t0 = lax.cummax(jnp.where(h0, iota_c, 0), axis=1)
    tF = lax.cummax(jnp.where(hF, iota_c, 0), axis=1)
    pad = pos_s < 0
    r_new = jnp.where(pad, _BIG, ks[0] + (tF - t0))
    nxt = jnp.concatenate([hF[:, 1:], ones], axis=1)
    still = jnp.logical_not(hF & nxt) & jnp.logical_not(pad)
    return pos_s, r_new, jnp.sum(still.astype(jnp.int32), axis=1)


def _compact_from_round2(si, rs, active_s, cap: int):
    """Per-row active (position, rank) pairs from a round's own sorted
    order — one batched sort (the 2D analog of fast2._compact_from_round)."""
    B, n = si.shape
    key = jnp.where(active_s, jnp.int32(0), jnp.int32(1))
    _, apos, ar0 = lax.sort((key, si, rs), num_keys=1, dimension=1)
    nact = jnp.sum(active_s.astype(jnp.int32), axis=1, keepdims=True)
    keep = _row_iota(B, cap) < nact
    return (
        jnp.where(keep, apos[:, :cap], jnp.int32(-1)),
        jnp.where(keep, ar0[:, :cap], _BIG),
    )


def _round_active2c(rank, apos, ar0, k, sentinel: str):
    """Narrowed quadrupling round per row, carrying r0 (3 gathers/row)."""
    B, n = rank.shape
    C = apos.shape[1]
    iota_c = _row_iota(B, C)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    valid = apos >= 0
    safe = jnp.where(valid, apos, 0)

    def shifted(j):
        p = safe + j * k
        ok = valid & (p < n)
        return jnp.where(ok, _take_rows(rank, jnp.minimum(p, n - 1)), off_end)

    r1, r2, r3 = shifted(1), shifted(2), shifted(3)
    r0 = jnp.where(valid, ar0, _BIG)
    pos_key = jnp.where(valid, apos, jnp.int32(-1))
    r0_s, r1_s, r2_s, r3_s, pos_s = lax.sort(
        (r0, r1, r2, r3, pos_key), num_keys=4, dimension=1
    )

    ones = jnp.ones((B, 1), jnp.bool_)
    h0 = jnp.concatenate([ones, r0_s[:, 1:] != r0_s[:, :-1]], axis=1)
    h4 = h0 | jnp.concatenate(
        [
            ones,
            (r1_s[:, 1:] != r1_s[:, :-1])
            | (r2_s[:, 1:] != r2_s[:, :-1])
            | (r3_s[:, 1:] != r3_s[:, :-1]),
        ],
        axis=1,
    )
    t0 = lax.cummax(jnp.where(h0, iota_c, 0), axis=1)
    t4 = lax.cummax(jnp.where(h4, iota_c, 0), axis=1)
    new_rank_s = r0_s + (t4 - t0)

    pad = pos_s < 0
    nxt_h4 = jnp.concatenate([h4[:, 1:], ones], axis=1)
    still = jnp.logical_not(h4 & nxt_h4) & jnp.logical_not(pad)

    new_rank_s = jnp.where(pad, jnp.int32(0), new_rank_s)
    upd_pos = jnp.where(pad, jnp.int32(n), pos_s)
    rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, C))
    rank = rank.at[rows, upd_pos].set(new_rank_s, mode="drop")

    key = jnp.where(still, jnp.int32(0), jnp.int32(1))
    _, new_apos, new_ar0 = lax.sort(
        (key, jnp.where(still, pos_s, jnp.int32(-1)), new_rank_s),
        num_keys=1,
        dimension=1,
    )
    nactive = jnp.sum(still.astype(jnp.int32), axis=1)
    keep = iota_c < nactive[:, None]
    return (
        rank,
        jnp.where(keep, new_apos, jnp.int32(-1)),
        jnp.where(keep, new_ar0, _BIG),
        nactive,
    )


def _narrow_cascade2(rank, k, na, apos, ar0, sentinel: str, caps):
    """2D narrowing cascade at static capacities (fast2._narrow_cascade)."""
    B, n = rank.shape

    def stage(carry, cap: int, next_cap):
        k, rank, apos, ar0, na = carry

        def cond(state):
            k, rank, apos, ar0, na = state
            m = jnp.max(na)
            more = (m > next_cap) if next_cap is not None else (m > 0)
            return more & (m > 0) & (k < n)

        def body(state):
            k, rank, apos, ar0, _ = state
            rank, apos, ar0, na = _round_active2c(rank, apos, ar0, k, sentinel)
            return k * 4, rank, apos, ar0, na

        return lax.while_loop(cond, body, (k, rank, apos, ar0, na))

    carry = (k, rank, apos, ar0, na)
    for i, cap in enumerate(caps):
        next_cap = caps[i + 1] if i + 1 < len(caps) else None
        if i > 0:
            def shrink(c, cap=cap):
                k, rank, apos, ar0, na = c
                keyc = jnp.where(apos >= 0, jnp.int32(0), jnp.int32(1))
                _, aposc, ar0c = lax.sort((keyc, apos, ar0), num_keys=1, dimension=1)
                keep = _row_iota(B, cap) < na[:, None]
                return (
                    k,
                    rank,
                    jnp.where(keep, aposc[:, :cap], jnp.int32(-1)),
                    jnp.where(keep, ar0c[:, :cap], _BIG),
                    na,
                )

            def hold(c, cap=cap):
                k, rank, apos, ar0, na = c
                return (
                    k,
                    rank,
                    jnp.full((B, cap), jnp.int32(-1)),
                    jnp.full((B, cap), _BIG),
                    na,
                )

            carry = lax.cond(jnp.max(carry[4]) > 0, shrink, hold, carry)
        carry = lax.cond(
            (jnp.max(carry[4]) > 0) & (carry[0] < n),
            lambda c, cap=cap, nc=next_cap: stage(c, cap, nc),
            lambda c: c,
            carry,
        )
    k, rank, _, _, na = carry
    return k, rank, na


def _bwt_batched_v3_impl(data2: jnp.ndarray, sentinel: str, want_rank: bool):
    """Shared v3 body: returns (L2, base2, rank2) where rank2 is the final
    full-width rank array when ``want_rank`` (paying the one inversion sort
    the unranked path elides) and a (B, 0) placeholder otherwise."""
    B, n = data2.shape
    cap1 = max(min(n, 4096), n // 16)
    cap2 = max(min(n, 4096), n // 256)
    cap3 = min(n, 4096)
    prev2 = jnp.roll(data2, 1, axis=1)
    si, rs, ac, na, prev_s = _bootstrap_sorted2(data2, prev2, sentinel)
    G0 = _trigram_keys2(data2, sentinel)[:, :n]

    def full_cond(state):
        k, si, rs, ac, na, prev_s, G = state
        return (jnp.max(na) * 16 > n) & (jnp.max(na) > 0) & (k < n)

    def full_body(state):
        k, si, rs, ac, na, prev_s, G = state
        si, rs, ac, na, prev_s, rank = _round_full_sorted2(
            si, rs, prev2, k, sentinel
        )
        return k * 4, si, rs, ac, na, prev_s, rank

    k, si, rs, ac, na, prev_s, G = lax.while_loop(
        full_cond, full_body, (jnp.int32(12), si, rs, ac, na, prev_s, G0)
    )

    def _rank_placeholder():
        return jnp.zeros((B, 0), jnp.int32)

    # Inversion-free micro tail, run UNCONDITIONALLY (fixed ~tens of ms):
    # when a block resolved inside the loop its extraction is all-pads and
    # both micro rounds no-op; when every block's residue fits cap3 and the
    # two rounds resolve it, the cheap emit below applies.  Flat structure
    # on purpose — a nested lax.cond tree (direct/micro/cascade) compiles
    # fine piecewise but the composed program's compile time explodes;
    # with one cond it compiles.
    apos_m, ar0_m = _extract_actives_sorted2(si, rs, ac, na, cap3)
    g = jnp.maximum(k // 4, 1)
    pos1, r1m, _na1 = _micro_round2(G, g, apos_m, ar0_m, 4, 16, sentinel)
    mpos, mr, mna = _micro_round2(G, g, pos1, r1m, 16, 64, sentinel)
    micro_done = (jnp.max(na) <= cap3) & (jnp.max(mna) == 0)

    def emit_micro(args):
        """Scatter-correct the carried payload at the refined actives."""
        k, si, rs, ac, na, prev_s, G, pos, r = args
        W = pos.shape[1]
        rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, W))
        valid = pos >= 0
        safe = jnp.where(valid, pos, 0)
        tgt = jnp.where(valid, r, jnp.int32(n))
        L = prev_s.at[rows, tgt].set(_take_rows(prev2, safe), mode="drop")
        b_slot = jnp.argmax(si == 0, axis=1).astype(jnp.int32)
        r_pos0 = jnp.take_along_axis(rs, b_slot[:, None], axis=1)[:, 0]
        base = jnp.maximum(
            r_pos0,
            jnp.max(
                jnp.where(valid & (pos == 0), r, jnp.int32(-1)), axis=1
            ),
        )
        if want_rank:
            # resolved ranks never move (positional-rank invariant); only
            # the refined actives' slots differ from the coarse inversion
            rank = _invert_rows(si, rs)
            rank = rank.at[rows, jnp.where(valid, pos, jnp.int32(n))].set(
                jnp.where(valid, r, 0), mode="drop"
            )
        else:
            rank = _rank_placeholder()
        return L, base, rank

    def cascade_path(args):
        k, si, rs, ac, na, prev_s, G, pos, r = args
        rank = _invert_rows(si, rs)
        apos, ar0 = _compact_from_round2(si, rs, ac, cap1)
        apos0 = apos  # entry actives: only these rows' slots can move

        k, rank, na2 = _narrow_cascade2(
            rank, k, na, apos, ar0, sentinel, (cap1, cap2, cap3)
        )

        # scatter-correct only the entry actives per row (resolved
        # suffixes' ranks never moved)
        rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, cap1))
        safe0 = jnp.where(apos0 >= 0, apos0, 0)
        final_r = jnp.where(
            apos0 >= 0, _take_rows(rank, safe0), jnp.int32(n)
        )
        L = prev_s.at[rows, final_r].set(_take_rows(prev2, safe0), mode="drop")
        return L, rank[:, 0], (rank if want_rank else _rank_placeholder())

    return lax.cond(
        micro_done,
        emit_micro,
        cascade_path,
        (k, si, rs, ac, na, prev_s, G, mpos, mr),
    )


def _micro_state(data2: jnp.ndarray, sentinel: str):
    """Shared fast-path body: bootstrap -> full quadrupling rounds -> tile
    extraction -> two inversion-free micro rounds.  Returns everything the
    emitters need plus the per-row ``resolved`` mask (True iff that row's
    residue fit the micro tail and fully refined).  Contains NO narrowing
    cascade and NO lax.cond, which keeps the container's default program
    small and its compile short."""
    B, n = data2.shape
    cap3 = min(n, 4096)
    prev2 = jnp.roll(data2, 1, axis=1)
    si, rs, ac, na, prev_s = _bootstrap_sorted2(data2, prev2, sentinel)
    G0 = _trigram_keys2(data2, sentinel)[:, :n]

    def full_cond(state):
        k, si, rs, ac, na, prev_s, G = state
        return (jnp.max(na) * 16 > n) & (jnp.max(na) > 0) & (k < n)

    def full_body(state):
        k, si, rs, ac, na, prev_s, G = state
        si, rs, ac, na, prev_s, rank = _round_full_sorted2(
            si, rs, prev2, k, sentinel
        )
        return k * 4, si, rs, ac, na, prev_s, rank

    k, si, rs, ac, na, prev_s, G = lax.while_loop(
        full_cond, full_body, (jnp.int32(12), si, rs, ac, na, prev_s, G0)
    )

    apos_m, ar0_m = _extract_actives_sorted2(si, rs, ac, na, cap3)
    g = jnp.maximum(k // 4, 1)
    pos1, r1m, _na1 = _micro_round2(G, g, apos_m, ar0_m, 4, 16, sentinel)
    mpos, mr, mna = _micro_round2(G, g, pos1, r1m, 16, 64, sentinel)
    # per-row: extraction is only faithful when that row's actives fit cap3,
    # and the row is done only when its own micro residue emptied
    resolved = (na <= cap3) & (mna == 0)
    return prev2, si, rs, prev_s, mpos, mr, resolved


def _emit_micro2(prev2, si, rs, prev_s, pos, r):
    """Scatter-correct the carried payload at the refined actives; compute
    per-row base.  Valid only for rows whose ``resolved`` flag is True."""
    B, n = si.shape
    W = pos.shape[1]
    rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, W))
    valid = pos >= 0
    safe = jnp.where(valid, pos, 0)
    tgt = jnp.where(valid, r, jnp.int32(n))
    L = prev_s.at[rows, tgt].set(_take_rows(prev2, safe), mode="drop")
    b_slot = jnp.argmax(si == 0, axis=1).astype(jnp.int32)
    r_pos0 = jnp.take_along_axis(rs, b_slot[:, None], axis=1)[:, 0]
    base = jnp.maximum(
        r_pos0,
        jnp.max(jnp.where(valid & (pos == 0), r, jnp.int32(-1)), axis=1),
    )
    return L, base


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_batched_micro(data2: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Block-parallel forward BWT, fast path only: (L2, base2, resolved2).

    The production program for the block container (final/x1/ArchonX1.c:53-60
    block loop): identical math to ``bwt_batched_v3`` up to the micro tail,
    but the narrowing cascade — needed only for >4096-active or >16k-deep
    residues, which real text never produces — is NOT in the graph.  Rows
    with ``resolved2[b] == False`` carry garbage in L2/base2 and must be
    recomputed by the caller (io.blocks re-dispatches them through the 1D
    cascade path).  Splitting the rare path out keeps this XLA program
    small and its compile short."""
    B, n = data2.shape
    if n <= 1:
        return data2, jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.bool_)
    prev2, si, rs, prev_s, pos, r, resolved = _micro_state(data2, sentinel)
    L, base = _emit_micro2(prev2, si, rs, prev_s, pos, r)
    return L, base, resolved


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_batched_micro_certified(data2: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Fast path with the always-on per-block LF certificate compiled in
    (a4/src/main.c:7 VERIFY; a6/src/bwt.c:19-23 VERIFY=VF_SORT): returns
    (L2, base2, ok2, resolved2).  ok2 is meaningful only where resolved2."""
    B, n = data2.shape
    if n <= 1:
        return (
            data2,
            jnp.zeros((B,), jnp.int32),
            jnp.ones((B,), jnp.bool_),
            jnp.ones((B,), jnp.bool_),
        )
    prev2, si, rs, prev_s, pos, r, resolved = _micro_state(data2, sentinel)
    L, base = _emit_micro2(prev2, si, rs, prev_s, pos, r)
    W = pos.shape[1]
    rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, W))
    valid = pos >= 0
    rank = _invert_rows(si, rs)
    rank = rank.at[rows, jnp.where(valid, pos, jnp.int32(n))].set(
        jnp.where(valid, r, 0), mode="drop"
    )
    ok = verify_bwt_batched(data2, rank, L, base, sentinel)
    return L, base, ok, resolved


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_batched_v3(data2: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Block-parallel forward BWT, v3 structure: returns (L2, base2).

    Full rounds carry the previous-byte payload and defer rank inversion;
    when every block resolves inside the full-round loop (the common case
    for text) L2 is the carried payload directly — no inversions, no
    emission sorts.  Small residues (<= 4096 actives in every block) take
    the inversion-free micro tail (tile extraction + two static multi-key
    refinement rounds against the carried coarse rank snapshot — no
    full-width sorts; see fast2.bwt_v3); only large or >16k-deep residues
    pay the full-width narrowing cascade."""
    B, n = data2.shape
    if n <= 1:
        return data2, jnp.zeros((B,), jnp.int32)
    L, base, _ = _bwt_batched_v3_impl(data2, sentinel, want_rank=False)
    return L, base


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_batched_v3_certified(data2: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Forward BWT with the always-on certificate the reference production
    binaries keep compiled in (a4/src/main.c:7 VERIFY; a6/src/bwt.c:19-23
    VERIFY=VF_SORT verifies during output): returns (L2, base2, ok2).

    ok2[b] is a full sufficiency certificate for block b — rank2 is a
    permutation whose sorted order lists suffixes in strictly increasing
    (char, next-suffix-rank) order, L2/base2 agree with that rank array —
    computed with one extra rank inversion plus one certificate sort per
    block on top of the v3 pipeline."""
    B, n = data2.shape
    if n <= 1:
        return data2, jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.bool_)
    L, base, rank = _bwt_batched_v3_impl(data2, sentinel, want_rank=True)
    ok = verify_bwt_batched(data2, rank, L, base, sentinel)
    return L, base, ok


@functools.partial(jax.jit, static_argnames=("sentinel",))
def verify_bwt_batched(
    data2: jnp.ndarray,
    rank2: jnp.ndarray,
    L2: jnp.ndarray,
    base2: jnp.ndarray,
    sentinel: str = SENT_SMALL,
) -> jnp.ndarray:
    """Per-row BWT certificate (batched analog of core.bwt.verify_sa, fused
    with the emission check): True iff rank2 is the rank array of row data
    under the sentinel convention AND (L2, base2) is its BWT emission.

    One 1-key sort with three payloads does all the work: sorting by rank
    yields the SA order, where the first chars, successor ranks, and
    previous bytes arrive as payloads — the reference's O(N) LF walk
    (a4/src/archon.c:210-225) with zero random gathers."""
    B, n = data2.shape
    if n == 0:
        return jnp.ones((B,), jnp.bool_)
    iota2 = _row_iota(B, n)
    off = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    nxt = jnp.where(
        iota2 + 1 < n,
        jnp.concatenate([rank2[:, 1:], rank2[:, :1]], axis=1),
        off,
    )
    prev2 = jnp.roll(data2, 1, axis=1)
    r_s, c_s, nxt_s, L_s = lax.sort(
        (rank2, data2.astype(jnp.int32), nxt, prev2), num_keys=1, dimension=1
    )
    perm_ok = jnp.all(r_s == iota2, axis=1)
    c_lt = c_s[:, :-1] < c_s[:, 1:]
    c_eq = c_s[:, :-1] == c_s[:, 1:]
    adj_ok = (
        jnp.all(c_lt | (c_eq & (nxt_s[:, :-1] < nxt_s[:, 1:])), axis=1)
        if n > 1
        else jnp.ones((B,), jnp.bool_)
    )
    L_ok = jnp.all(L_s == L2, axis=1)
    base_ok = base2 == rank2[:, 0]
    return perm_ok & adj_ok & L_ok & base_ok


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_forward_batched(data2: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Block-parallel forward BWT: (B, n) uint8 -> (L2, base2, rank2).

    L2[b, rank2[b, p]] = data2[b, (p-1) mod n]; base2[b] = rank2[b, 0].
    Rank-direct emission (no SA inversion, no random gather), per block —
    the batched analog of core.bwt.bwt_forward_fast.
    """
    B, n = data2.shape
    rank = suffix_ranks_batched(data2, sentinel)
    prev = jnp.roll(data2, 1, axis=1)
    rows = jnp.broadcast_to(lax.iota(jnp.int32, B)[:, None], (B, n))
    L = jnp.zeros((B, n), jnp.uint8).at[rows, rank].set(prev)
    base = rank[:, 0]
    return L, base, rank


def suffix_arrays_batched(data2, sentinel: str = SENT_SMALL):
    """Per-row suffix arrays (host convenience; inverts the rank rows)."""
    arr = jnp.asarray(np.ascontiguousarray(data2), dtype=jnp.uint8)
    rank = suffix_ranks_batched(arr, sentinel)
    B, n = arr.shape
    return np.asarray(_invert_rows(rank, _row_iota(B, n)))
