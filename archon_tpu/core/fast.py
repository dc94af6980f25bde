"""Host-orchestrated suffix array with active-set narrowing.

Real corpora contain long repeats (quotes, boilerplate, the Gauntlet
pathological family), which force the doubling loop to large k even though
only a shrinking fraction of suffixes is still tied.  The all-device
``core.doubling.suffix_array`` pays full-array cost every round; this module
narrows each refinement round to the *active* suffixes (members of
non-singleton rank groups), the data-parallel analog of Larsson-Sadakane group
refinement — and the structural answer to the reference's anchor/LSC
"defense" machinery (a4/src/direct.c:82-161): pathological repetitions cost
O(active · log) here instead of blowing up a comparison sort.

Key invariant: ranks are *positional* — rank[p] = sorted position of p's
group head — so refining a subset assigns globally consistent new ranks
(group head position + subgroup offset) without renumbering anything else.

The production entry (`suffix_array_fused`) fuses everything — init, full
rounds, cond-guarded compactions, narrowed rounds, final inversion — into a
single jit so no host round trip happens mid-computation.  The per-stage
jitted wrappers remain for tests and instrumentation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .doubling import SENT_LARGE, SENT_SMALL, _initial_rank, _invert_permutation, _shifted_rank


def _positional_ranks(head: jnp.ndarray, iota: jnp.ndarray):
    """rank-by-sorted-slot = position of the group head (cummax of head slots)."""
    return lax.cummax(jnp.where(head.astype(bool), iota, 0))


def _actives_from_heads(head: jnp.ndarray):
    """active[t] = sorted slot t belongs to a group of size > 1."""
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), head.dtype)])
    return jnp.logical_not(head.astype(bool) & nxt.astype(bool))


def _init_body(data: jnp.ndarray, sentinel: str):
    n = data.shape[0]
    iota = lax.iota(jnp.int32, n)
    ext = data.astype(jnp.int32) + 1
    pad_val = jnp.int32(0 if sentinel == SENT_SMALL else 511)
    extp = jnp.concatenate([ext, jnp.full((2,), pad_val, jnp.int32)])
    packed = extp[:n] * (512 * 512) + extp[1 : n + 1] * 512 + extp[2 : n + 2]
    sorted_keys, sorted_idx = lax.sort((packed, iota), num_keys=1)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), (sorted_keys[1:] != sorted_keys[:-1]).astype(jnp.int32)]
    )
    ranks_sorted = _positional_ranks(head, iota)
    rank = _invert_permutation(sorted_idx, ranks_sorted)
    active = _actives_from_heads(head)
    return rank, jnp.sum(active.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def _init(data: jnp.ndarray, sentinel: str):
    return _init_body(data, sentinel)


def _round_full_body(rank: jnp.ndarray, k, sentinel: str):
    n = rank.shape[0]
    iota = lax.iota(jnp.int32, n)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    padded = jnp.concatenate([rank, jnp.full((n,), off_end, jnp.int32)])
    r1 = _shifted_rank(padded, iota, n, k, off_end)
    r2 = _shifted_rank(padded, iota, n, 2 * k, off_end)
    r3 = _shifted_rank(padded, iota, n, 3 * k, off_end)
    r0_s, r1_s, r2_s, r3_s, sorted_idx = lax.sort((rank, r1, r2, r3, iota), num_keys=4)
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
    ranks_sorted = _positional_ranks(head, iota)
    new_rank = _invert_permutation(sorted_idx, ranks_sorted)
    active = _actives_from_heads(head)
    return new_rank, jnp.sum(active.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def _round_full(rank: jnp.ndarray, k: jnp.ndarray, sentinel: str):
    return _round_full_body(rank, k, sentinel)


def _compact_body(rank: jnp.ndarray, cap: int):
    """Positions belonging to non-singleton groups, padded to cap with -1."""
    n = rank.shape[0]
    iota = lax.iota(jnp.int32, n)
    r_s, idx_s = lax.sort((rank, iota), num_keys=1)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), (r_s[1:] != r_s[:-1]).astype(jnp.int32)]
    )
    active = _actives_from_heads(head)
    # sort actives to the front (stable -> keeps rank order, irrelevant here)
    key = jnp.where(active, jnp.int32(0), jnp.int32(1))
    _, pos = lax.sort((key, idx_s), num_keys=1)
    out = jnp.where(lax.iota(jnp.int32, cap) < jnp.sum(active.astype(jnp.int32)),
                    pos[:cap], jnp.int32(-1))
    return out


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact(rank: jnp.ndarray, cap: int):
    return _compact_body(rank, cap)


def _round_active_body(rank: jnp.ndarray, apos: jnp.ndarray, k, sentinel: str):
    """Refine only the active positions (capacity C = apos.shape[0])."""
    n = rank.shape[0]
    C = apos.shape[0]
    iota_c = lax.iota(jnp.int32, C)
    off_end = jnp.int32(-1) if sentinel == SENT_SMALL else jnp.int32(n + 1)
    valid = apos >= 0
    safe = jnp.where(valid, apos, 0)
    BIG = jnp.int32(0x7FFFFFFF)

    r0 = jnp.where(valid, rank[safe], BIG)

    def shifted(j):
        p = safe + j * k
        ok = valid & (p < n)
        return jnp.where(ok, rank[jnp.minimum(p, n - 1)], off_end)

    r1, r2, r3 = shifted(1), shifted(2), shifted(3)
    r0_s, r1_s, r2_s, r3_s, pos_s = lax.sort((r0, r1, r2, r3, safe_where(valid, apos)), num_keys=4)

    h0 = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), r0_s[1:] != r0_s[:-1]]
    )
    h4 = h0 | jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (r1_s[1:] != r1_s[:-1]) | (r2_s[1:] != r2_s[:-1]) | (r3_s[1:] != r3_s[:-1]),
        ]
    )
    t0 = lax.cummax(jnp.where(h0, iota_c, 0))  # slot of r0-group head
    t4 = lax.cummax(jnp.where(h4, iota_c, 0))  # slot of subgroup head
    new_rank_s = r0_s + (t4 - t0)

    pad = pos_s < 0
    # still-active: subgroup of size > 1
    nxt_h4 = jnp.concatenate([h4[1:], jnp.ones((1,), jnp.bool_)])
    still = jnp.logical_not(h4 & nxt_h4) & jnp.logical_not(pad)

    new_rank_s = jnp.where(pad, jnp.int32(0), new_rank_s)
    upd_pos = jnp.where(pad, jnp.int32(n), pos_s)  # drop pads
    rank = rank.at[upd_pos].set(new_rank_s, mode="drop")

    # compact the still-active positions to the front
    key = jnp.where(still, jnp.int32(0), jnp.int32(1))
    _, new_apos = lax.sort((key, jnp.where(still, pos_s, jnp.int32(-1))), num_keys=1)
    nactive = jnp.sum(still.astype(jnp.int32))
    new_apos = jnp.where(iota_c < nactive, new_apos, jnp.int32(-1))
    return rank, new_apos, nactive


@functools.partial(jax.jit, static_argnames=("sentinel",))
def _round_active(rank: jnp.ndarray, apos: jnp.ndarray, k: jnp.ndarray, sentinel: str):
    return _round_active_body(rank, apos, k, sentinel)


def safe_where(valid, apos):
    # pads carry -1 so they sort deterministically and are dropped later
    return jnp.where(valid, apos, jnp.int32(-1))


@functools.partial(jax.jit, static_argnames=())
def _finish(rank: jnp.ndarray):
    n = rank.shape[0]
    return _invert_permutation(rank, lax.iota(jnp.int32, n))


@functools.partial(jax.jit, static_argnames=("sentinel", "stop_den"))
def _phase_full(rank, k, nactive, sentinel: str, stop_den: int):
    """Fused full-size rounds: loop on device until the active fraction
    drops below 1/stop_den (or done) — a single host sync per phase instead
    of one per round."""
    n = rank.shape[0]

    def cond(state):
        k, rank, nactive = state
        return (nactive * stop_den > n) & (nactive > 0) & (k < n)

    def body(state):
        k, rank, _ = state
        new_rank, na = _round_full_body(rank, k, sentinel)
        return k * 4, new_rank, na

    return lax.while_loop(cond, body, (k, rank, nactive))


@functools.partial(jax.jit, static_argnames=("sentinel", "stop_den"))
def _phase_active(rank, apos, k, nactive, sentinel: str, stop_den: int):
    """Fused narrowed rounds at fixed capacity C = apos.shape[0]."""
    n = rank.shape[0]

    def cond(state):
        k, rank, apos, nactive = state
        more = (nactive * stop_den > n) if stop_den else (nactive > 0)
        return more & (nactive > 0) & (k < n)

    def body(state):
        k, rank, apos, _ = state
        rank, apos, na = _round_active_body(rank, apos, k, sentinel)
        return k * 4, rank, apos, na

    return lax.while_loop(cond, body, (k, rank, apos, nactive))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_array_fused(data: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """Fully fused narrowed suffix array: one jit, zero mid-computation host
    syncs (the phased variant pays one per phase).

    Structure: init -> while_loop of full rounds while >1/4 of suffixes are
    tied -> (cond-guarded) compaction to capacity n/4 + narrowed while_loop
    while >1/32 tied -> (cond-guarded) compaction to n/32 + narrowed
    while_loop to completion -> final inversion.  The compaction/narrowed
    stages are skipped on-device when everything already resolved.
    """
    n = data.shape[0]
    if n <= 1:
        return jnp.zeros((n,), jnp.int32)
    rank, nactive = _init_body(data, sentinel)

    def full_cond(state):
        k, rank, na = state
        return (na * 4 > n) & (na > 0) & (k < n)

    def full_body(state):
        k, rank, _ = state
        new_rank, na = _round_full_body(rank, k, sentinel)
        return k * 4, new_rank, na

    k, rank, nactive = lax.while_loop(
        full_cond, full_body, (jnp.int32(3), rank, nactive)
    )

    def narrowed_stage(k, rank, nactive, cap, stop_den):
        def run(args):
            k, rank, na = args
            apos = _compact_body(rank, cap)

            def cond(state):
                k, rank, apos, na = state
                more = (na * stop_den > n) if stop_den else (na > 0)
                return more & (na > 0) & (k < n)

            def body(state):
                k, rank, apos, _ = state
                rank, apos, na = _round_active_body(rank, apos, k, sentinel)
                return k * 4, rank, apos, na

            k, rank, _, na = lax.while_loop(cond, body, (k, rank, apos, na))
            return k, rank, na

        return lax.cond(
            (nactive > 0) & (k < n), run, lambda a: a, (k, rank, nactive)
        )

    cap1 = max(min(n, 4096), n // 4)
    cap2 = max(min(n, 4096), n // 32)
    k, rank, nactive = narrowed_stage(k, rank, nactive, cap1, 32)
    k, rank, nactive = narrowed_stage(k, rank, nactive, cap2, 0)
    return _invert_permutation(rank, lax.iota(jnp.int32, n))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_ranks_fused(data: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """Like suffix_array_fused but returns the rank array (inverse SA) and
    skips the final inversion sort — BWT emission only needs ranks (see
    core/bwt.bwt_forward_fast), saving an inversion sort + payload gather."""
    n = data.shape[0]
    if n <= 1:
        return jnp.zeros((n,), jnp.int32)
    rank, nactive = _init_body(data, sentinel)

    def full_cond(state):
        k, rank, na = state
        return (na * 4 > n) & (na > 0) & (k < n)

    def full_body(state):
        k, rank, _ = state
        new_rank, na = _round_full_body(rank, k, sentinel)
        return k * 4, new_rank, na

    k, rank, nactive = lax.while_loop(
        full_cond, full_body, (jnp.int32(3), rank, nactive)
    )

    def narrowed_stage(k, rank, nactive, cap, stop_den):
        def run(args):
            k, rank, na = args
            apos = _compact_body(rank, cap)

            def cond(state):
                k, rank, apos, na = state
                more = (na * stop_den > n) if stop_den else (na > 0)
                return more & (na > 0) & (k < n)

            def body(state):
                k, rank, apos, _ = state
                rank, apos, na = _round_active_body(rank, apos, k, sentinel)
                return k * 4, rank, apos, na

            k, rank, _, na = lax.while_loop(cond, body, (k, rank, apos, na))
            return k, rank, na

        return lax.cond(
            (nactive > 0) & (k < n), run, lambda a: a, (k, rank, nactive)
        )

    cap1 = max(min(n, 4096), n // 4)
    cap2 = max(min(n, 4096), n // 32)
    k, rank, nactive = narrowed_stage(k, rank, nactive, cap1, 32)
    k, rank, nactive = narrowed_stage(k, rank, nactive, cap2, 0)
    return rank


def suffix_array_fast(data, sentinel: str = SENT_SMALL, return_device: bool = False):
    """Narrowed suffix array (single fused jit call).

    Semantically identical to core.doubling.suffix_array (golden-tested);
    structurally superior on repetition-heavy inputs where ties persist to
    large k.  ``return_device=True`` keeps the result on device for a
    caller that consumes it there.
    """
    arr = jnp.asarray(data, dtype=jnp.uint8) if not isinstance(data, jnp.ndarray) else data
    n = arr.shape[0]
    if n <= 1:
        return np.zeros(n, np.int32)
    sa = suffix_array_fused(arr, sentinel)
    return sa if return_device else np.asarray(sa)
