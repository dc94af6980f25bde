"""Itoh-Tanaka reduced-volume BWT — the round-5 decision measurement.

The reference's core economy is sorting only a FRACTION of suffixes: a4
direct-sorts the ~1/3 "lucky" suffixes satisfying
``fly[0] > fly[1] && fly[0] >= fly[-1]`` (a4/src/archon.c:163-169) and
derives the other 2/3 with two sequential induction waves (:172-194);
a5's order-4 split gets direct volume to ~12%
(a5/tool/estimate/result/4.txt).  This module is that idea made exact on a
sort-network machine:

1. **Lucky classification** (vectorized a4 predicate): lucky positions are
   descent maxima — s[x] > s[x+1] and s[x] >= s[x-1].  Two lucky positions
   are never adjacent, and identical text windows have identical interior
   lucky structure (the predicate reads chars only).
2. **Phrase reduction**: the text factors into phrases [q_i, q_{i+1}]
   (lucky to next lucky, inclusive overlap — the LMS-substring shape of
   SA-IS, a7/src/archon.cpp:160-172, but at IT-2 lucky boundaries).  One
   n-wide multi-key sort names all phrases (packed char digits, see the
   lemma below); the reduced string of names (m ~ n/3) solves on the
   measurement-tuned v3 engine (fast2.suffix_ranks_windows) with REGULAR
   slices — no per-round gathers, which cost more per element than a
   sort slot.
3. **One-sort induced merge**: every suffix x gets the key
   (chars s[x..e_x] padded, R*[e_x]) where e_x is the next lucky position
   and R* the reduced ranks — ONE n-wide sort interleaves derived and
   direct suffixes exactly, replacing the reference's two sequential waves.

**The exactness lemma** (why no SA-IS type alphabet is needed): suppose
suffixes x and y compare with equal chars through offset h-1 and h >= 1,
where x+h == e_x is x's lucky cap but y+h is strictly inside y's phrase
(hence non-lucky).  Matched chars at h-1 and h give s[y+h] >= s[y+h-1], so
non-luckiness of y+h forces s[y+h] <= s[y+h+1]; luckiness of x+h gives
s[x+h+1] < s[x+h] = s[y+h] <= s[y+h+1] — the comparison is decided
STRICTLY at offset h+1 with suffix(x) < suffix(y), REGARDLESS of either
continuation.  Past-cap key digits therefore encode "below every real
char" (digit 1 < char digits c+2) and the one-sort merge is exact; the
terminator (end of string, SENT_SMALL) takes digit 0, below both.  The
same argument makes phrase-name order consistent with extended-phrase
order, so the reduced-string suffix order equals the lucky-suffix order.

Deep phrases (length > the static window D) are handled exactly: naming
collisions among them invalidate the fast path (``ok=False`` — caller
falls back to bwt_v3), while induce-stage ties fall into tie groups with
guaranteed common context D+1 chars and are refined by the standard
narrowed cascade (fast2 machinery) — text never needs it; Gauntlet-class
periodicity falls back.

SENT_LARGE reduces to SENT_SMALL by complementing the text and reversing
the output (the a4 vs a7 convention duality, as in core/sais_tpu.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.scan import blocked_cummax
from .doubling import SENT_LARGE, SENT_SMALL, _invert_permutation
from .fast2 import (
    _BIG,
    _compact_from_round,
    _narrow_cascade,
    _narrow_caps,
    suffix_ranks_windows,
)

_DIGIT_BASE = 260  # digits: 0 terminator < 1 past-cap < chars c+2 (2..257)


def _lucky_mask(d: jnp.ndarray) -> jnp.ndarray:
    """a4's IT-2 predicate, terminator-smallest: s[x] > s[x+1] (off-end
    char counts smaller, so n-1 qualifies on the descent test) and
    s[x] >= s[x-1] (vacuous at x=0).  Ref: a4/src/archon.c:166."""
    n = d.shape[0]
    nxt = jnp.concatenate([d[1:], jnp.full((1,), -1, jnp.int32)])
    prv = jnp.concatenate([jnp.full((1,), -1, jnp.int32), d[:-1]])
    return (d > nxt) & (d >= prv)


def _next_lucky(lucky: jnp.ndarray, n: int) -> jnp.ndarray:
    """e[x] = smallest y > x with lucky[y] (position n — the terminator —
    is virtually lucky, capping every tail phrase)."""
    vals = jnp.where(lucky, lax.iota(jnp.int32, n), jnp.int32(n))
    revmin = lax.cummin(vals, reverse=True)
    return jnp.concatenate([revmin[1:], jnp.full((1,), jnp.int32(n))])


def _phrase_keys(d32: jnp.ndarray, dist: jnp.ndarray, D: int):
    """K = (D+1)/3 packed int32 keys per position: slot j carries the char
    digit s[x+j]+2 while j <= dist[x] (content INCLUDING the cap char),
    the terminator digit 0 at the string end, and the past-cap digit 1
    beyond — the lemma's exact ordering."""
    n = d32.shape[0]
    assert (D + 1) % 3 == 0
    iota = lax.iota(jnp.int32, n)
    # char digits over the extended domain [0, n]: terminator digit 0
    ext = jnp.concatenate([d32 + 2, jnp.zeros((D + 1,), jnp.int32)])
    keys = []
    for k in range((D + 1) // 3):
        packed = jnp.zeros((n,), jnp.int32)
        for t in range(3):
            j = 3 * k + t
            dig = jnp.where(
                (j <= dist) & (iota + j <= n),
                lax.slice(ext, (j,), (j + n,)),
                jnp.int32(1),
            )
            packed = packed * _DIGIT_BASE + dig
        keys.append(packed)
    return keys


@functools.partial(jax.jit, static_argnames=("D", "M"))
def _it2_stage1(data: jnp.ndarray, D: int, M: int):
    """Classify + name phrases + build the reduced string.  Returns
    (keys..., dist, s1, qpos, bad_name, overflow)."""
    n = data.shape[0]
    d32 = data.astype(jnp.int32)
    iota = lax.iota(jnp.int32, n)
    one = jnp.ones((1,), jnp.bool_)

    lucky = _lucky_mask(d32)
    e = _next_lucky(lucky, n)
    dist = e - iota  # phrase length in chars (cap char at slot dist)
    keys = _phrase_keys(d32, dist, D)
    K = len(keys)

    # --- phrase naming: one n-wide sort, lucky rows to the front
    flag = jnp.where(lucky, jnp.int32(0), jnp.int32(1))
    named = lax.sort(tuple([flag] + keys + [iota, dist]), num_keys=1 + K)
    flag_s, key_s, pos_s, dist_s = named[0], named[1 : 1 + K], named[1 + K], named[2 + K]
    head = jnp.concatenate([one, flag_s[1:] != flag_s[:-1]])
    neq = jnp.zeros((n - 1,), jnp.bool_)
    for ks in key_s:
        neq = neq | (ks[1:] != ks[:-1])
    head = head | jnp.concatenate([one, neq])
    names_s = blocked_cummax(jnp.where(head, iota, 0))
    # validity: equal truncated keys with both phrases deeper than D would
    # merge DISTINCT phrases into one name — unresolvable at this window
    bad_name = jnp.any(~head & (dist_s > D) & (flag_s == 0))

    # --- reduced string (names+1 in text order, 0-padded) at static M
    m = jnp.sum(lucky.astype(jnp.int32))
    overflow = m > M
    lucky_row = flag_s[:M] == 0
    poskey = jnp.where(lucky_row, pos_s[:M], _BIG)
    nameval = jnp.where(lucky_row, names_s[:M] + 1, jnp.int32(0))
    qpos, s1 = lax.sort((poskey, nameval), num_keys=1)
    s1 = jnp.where(lax.iota(jnp.int32, M) < m, s1, jnp.int32(0))
    return tuple(keys) + (dist, s1, qpos, bad_name, overflow)


@functools.partial(jax.jit, static_argnames=("D",))
def _it2_merge(data: jnp.ndarray, prev: jnp.ndarray, keys, dist, qpos,
               r_star, D: int):
    """One-sort induced merge.  Returns (L_direct, base_direct, na,
    ranks_sorted, mpos_s, active_s): when na == 0 (every tie group
    resolved — the text-corpus common case) L_direct/base_direct ARE the
    answer; otherwise ``_it2_residual`` refines.  The residual cascade
    lives in its OWN program: embedding it in a lax.cond branch here
    made the merge program's compile time explode — the host decides on
    the fetched na instead, exactly like the container's resolved-row
    check."""
    n = data.shape[0]
    iota = lax.iota(jnp.int32, n)
    one = jnp.ones((1,), jnp.bool_)
    K = len(keys)
    lucky = _lucky_mask(data.astype(jnp.int32))

    # --- propagate reduced ranks leftward: refnext[x] = r* of the first
    # lucky position > x.  Lucky positions are ordered, so that lucky's
    # 0-based index IS the inclusive-cumsum count c[x] of luckies <= x,
    # and the whole propagation is one native cumsum + one MONOTONE
    # n-from-M gather — both op classes the cascade's narrowed rounds
    # already use.  A scatter + custom first-valid associative_scan
    # formulation is avoided on purpose: a custom-combine scan lowers to a
    # log-depth slice/pad/concat HLO cascade whose compile time explodes
    # at multi-MiB widths.  c[x] == m (no lucky to the right) maps to the
    # terminator's never-tied -1.
    M = r_star.shape[0]
    m = jnp.sum(lucky.astype(jnp.int32))
    c = jnp.cumsum(lucky.astype(jnp.int32))
    refnext = jnp.where(
        c < m, r_star[jnp.minimum(c, jnp.int32(M - 1))], jnp.int32(-1)
    )
    refkey = jnp.where(dist <= D, refnext, _BIG)

    # --- one-sort induced merge: (phrase digits, reduced rank) + payload
    merged = lax.sort(tuple(keys) + (refkey, iota, prev), num_keys=K + 1)
    mkey_s, ref_s, mpos_s, prev_s = merged[:K], merged[K], merged[K + 1], merged[K + 2]
    mneq = ref_s[1:] != ref_s[:-1]
    for ks in mkey_s:
        mneq = mneq | (ks[1:] != ks[:-1])
    mhead = jnp.concatenate([one, mneq])
    ranks_sorted = blocked_cummax(jnp.where(mhead, iota, 0))
    nxt_h = jnp.concatenate([mhead[1:], one])
    active_s = jnp.logical_not(mhead & nxt_h)
    na = jnp.sum(active_s.astype(jnp.int32))

    base_direct = ranks_sorted[jnp.argmax(mpos_s == 0).astype(jnp.int32)]
    return prev_s, base_direct, na, ranks_sorted, mpos_s, active_s


@functools.partial(jax.jit, static_argnames=("D",))
def _it2_residual(prev: jnp.ndarray, prev_s: jnp.ndarray,
                  ranks_sorted: jnp.ndarray, mpos_s: jnp.ndarray,
                  active_s: jnp.ndarray, na: jnp.ndarray, D: int):
    """Residual refinement: tie groups (all with common context >= D+1
    chars by construction) refine through the standard narrowed cascade.
    A separate program from the merge — see ``_it2_merge``."""
    n = prev.shape[0]
    cap1, cap2, cap3 = _narrow_caps(n)
    rank = _invert_permutation(mpos_s, ranks_sorted)
    apos, ar0 = _compact_from_round(mpos_s, ranks_sorted, active_s, cap1)
    apos0 = apos
    _, rank, _ = _narrow_cascade(
        rank, jnp.int32(D + 1), na, apos, ar0, SENT_SMALL, (cap1, cap2, cap3)
    )
    safe0 = jnp.where(apos0 >= 0, apos0, 0)
    final_r = jnp.where(apos0 >= 0, rank[safe0], jnp.int32(n))
    L = prev_s.at[final_r].set(prev[safe0], mode="drop")
    return L, rank[0]


def _it2_dispatch(data: jnp.ndarray, prev: jnp.ndarray, D: int,
                  red_frac: float):
    """Enqueue the three jitted stage programs WITHOUT any host sync
    (splitting at the reduced-solve boundary keeps each program v3-sized,
    bounding compile time, AND reuses ``suffix_ranks_windows``'s own cache
    entry).  Returns the device-side state ``_it2_finish`` resolves."""
    import os
    import time as _time

    n = data.shape[0]
    # Round M UP to a power of two: the odd-length M = int(0.45 n)
    # reduced solve is the one shape class whose compile ever hung.
    # Power-of-two M costs a slightly larger reduced problem and removes
    # the pathology.
    M = min(n, max(4096, 1 << (int(n * red_frac) - 1).bit_length()))
    dbg = os.environ.get("ARCHON_IT2_DEBUG")

    def _tick(label, x):
        if dbg:
            t0 = _time.time()
            jnp.asarray(x)[..., :1].sum().item()
            print(f"[it2-debug] {label}: forced in {_time.time()-t0:.1f}s",
                  flush=True)

    out1 = _it2_stage1(data, D, M)
    keys, (dist, s1, qpos, bad_name, overflow) = out1[:-5], out1[-5:]
    _tick("stage1", s1)
    r_star = suffix_ranks_windows(s1, 1, SENT_SMALL)
    _tick("windows", r_star)
    L, base, na, ranks_sorted, mpos_s, active_s = _it2_merge(
        data, prev, keys, dist, qpos, r_star, D
    )
    _tick("merge", L)
    pre_bad = bad_name | overflow
    return (L, base, na, ranks_sorted, mpos_s, active_s, pre_bad, _tick)


def _it2_finish(prev: jnp.ndarray, state, D: int):
    """Resolve a dispatched it2 block: ONE host fetch of ``na`` decides
    whether the (separately jitted, rarely needed) residual cascade runs.
    The fetch lives HERE, not at dispatch time, so the streamed container
    pipelines it2 dispatches exactly like v3 dispatches."""
    L, base, na, ranks_sorted, mpos_s, active_s, pre_bad, _tick = state
    n = prev.shape[0]
    cap1, _c2, _c3 = _narrow_caps(n)
    if int(na) > 0:  # host-side branch: the residual cascade is its own
        # program, compiled only when a block actually needs it
        L, base = _it2_residual(
            prev, L, ranks_sorted, mpos_s, active_s, na, D
        )
        _tick("residual", L)
    ok = jnp.logical_not(pre_bad) & (na <= cap1)
    return L, base, ok


def bwt_it2_async(data: jnp.ndarray, sentinel: str = SENT_SMALL,
                  D: int = 11, red_frac: float = 0.45):
    """Pipelined form of ``bwt_it2``: enqueues the stage programs with NO
    host sync and returns a zero-arg ``finish() -> (L, base, ok)``.  The
    streamed container dispatches a window of blocks through this before
    finishing the oldest — the ``int(na)`` residual decision otherwise
    serializes every dispatch behind a host round trip, collapsing the
    stream into lockstep."""
    n = data.shape[0]
    if n <= 1:
        return lambda: (data, jnp.int32(0), jnp.bool_(True))
    prev = jnp.roll(data, 1)
    comp = sentinel == SENT_LARGE
    state = _it2_dispatch(
        jnp.uint8(255) - data if comp else data, prev, D, red_frac
    )

    def finish():
        L, b, ok = _it2_finish(prev, state, D)
        if comp:
            return L[::-1], jnp.int32(n - 1) - b, ok
        return L, b, ok

    return finish


def bwt_it2(data: jnp.ndarray, sentinel: str = SENT_SMALL, D: int = 11,
            red_frac: float = 0.45):
    """Forward BWT via the IT-2 reduced-volume structure: (L, base, ok).

    ``ok=False`` marks inputs the static window/reduction caps cannot name
    exactly (deep-phrase naming collisions, lucky fraction > red_frac, or
    an oversized induce residue); the caller must then fall back to
    ``bwt_v3`` — the same candidate + exact-check + fallback discipline
    the streamed container already applies per block.  NOT itself a jit:
    it orchestrates three jitted stage programs (see ``_it2_dispatch``)."""
    return bwt_it2_async(data, sentinel, D, red_frac)()
