"""Data-parallel induced sorting (SA-IS re-expressed as sorts and scans).

This is the a7-parity path at the *algorithm* level (reference: SA-IS with
Yuta Mori optimizations, a7/src/archon.cpp:8-11): LMS reduction + recursion
+ induced derivation.  The sequential bucket-pointer sweeps of the reference
(`inducePre`/`inducePost`, archon.cpp:387-562) cannot run as written on a
vector machine, so each phase is re-derived as sorts/scans:

1. **Type classification** (findLMS analog, archon.cpp:160-172): S/L types
   come from one reverse associative scan (first-nonzero-to-the-right of
   the neighbor comparison signs).
2. **LMS substring naming** (reduce/reduceFast analog, archon.cpp:581-649):
   ranks of *cap-bounded* windows over the (char,type) alphabet, doubling
   the window each round.  Caps compose exactly — every position strictly
   inside an LMS gap shares the same next-LMS — and a per-position
   "terminal" value enters the key the moment the window crosses the cap,
   so equal LMS substrings (incl. their closing symbol) get equal ranks in
   ceil(log2 max-gap) rounds.  The (char,type) pairwise order equals true
   suffix order (L sorts before S within a bucket — the bucket-head/tail
   placement rule of the reference), verified against the golden oracle.
3. **Recursion with strategy switch** (solve/type-squeeze analog,
   archon.cpp:668-689,808-815): the named string (m <= (n+1)/2) solves on
   the measurement-tuned doubling engine (`fast2.suffix_ranks_windows`) —
   the counterpart of a7 switching representations on the reduced
   problem.
4. **Induced derivation** (inducePost analog, archon.cpp:518-562): the
   L-suffix order is the capped-window rank where the terminal carries the
   *exact* LMS suffix rank (every maximal L-run ends at an LMS position by
   definition); the S-suffix order symmetrically caps at the next L-type
   with the L-ranks as terminals.  Each is the same kernel as naming with a
   different terminal seed — log2(max-gap) rounds instead of a sequential
   sweep.  A final 2-key sort over ((char,type), class-rank) interleaves
   the classes exactly as the reference's bucket scatter does.

Work: O(n log maxgap) + reduced-solve, vs O(n log maxdepth) for plain
doubling.  No wall-clock crossover against bwt_v3 has been measured
(scripts/measure_r3.py sais runs the comparison); v3 stays the production
default, and this path's value claim is algorithm parity with a7
(golden-tested both conventions), not throughput.

SENT_LARGE reduces to SENT_SMALL by complementing the text and reversing
the rank (a4 vs a7 convention duality; golden/sa.py documents both).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .doubling import SENT_LARGE, SENT_SMALL, _invert_permutation
from .fast2 import suffix_ranks_windows

_BIG = jnp.int32(0x3FFFFFFF)
_PAD = jnp.int32(-1)


def _joint_rank(a1, b1, a2, b2):
    """Dense joint rank of 2-key pairs from two aligned arrays.

    Ranks the multiset {(a1[i], b1[i])} ∪ {(a2[i], b2[i])} so window values
    and terminal values live on one comparable scale; returns the two rank
    arrays.  One (2n)-element 2-key sort + scan + inverse sort."""
    n1 = a1.shape[0]
    A = jnp.concatenate([a1, a2])
    B = jnp.concatenate([b1, b2])
    idx = lax.iota(jnp.int32, 2 * n1)
    A_s, B_s, idx_s = lax.sort((A, B, idx), num_keys=2)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), (A_s[1:] != A_s[:-1]) | (B_s[1:] != B_s[:-1])]
    )
    slot = lax.cummax(jnp.where(head, lax.iota(jnp.int32, 2 * n1), 0))
    r = _invert_permutation(idx_s, slot)
    return r[:n1], r[n1:]


def _capped_ranks(u, e, is_cap, ref):
    """Rank every position by its cap-bounded window.

    u: (n1,) int32 symbols; e[x]: cap position (the window covers
    [x, e[x]] inclusive, then pads); is_cap: positions that can serve as
    caps; ref: terminal refinement read at cap positions (the window's
    final key component is (u[cap], ref[cap]+1)).

    Equal windows (content + terminal) get equal ranks; distinct windows
    rank in true comparison order.  ceil(log2 max(e-x)) + 1 rounds."""
    n1 = u.shape[0]
    iota = lax.iota(jnp.int32, n1)
    v, T = _joint_rank(
        u,
        jnp.zeros((n1,), jnp.int32),
        u,
        jnp.where(is_cap, ref + 1, _BIG),
    )
    maxgap = jnp.max(e - iota)

    def cond(state):
        h, v, T = state
        return h <= maxgap

    def body(state):
        h, v, T = state
        xph = iota + h
        b = jnp.where(
            xph < e,
            v[jnp.minimum(xph, n1 - 1)],
            jnp.where(xph == e, T[jnp.minimum(e, n1 - 1)], _PAD),
        )
        v, T = _joint_rank(v, b, T, jnp.full((n1,), _PAD, jnp.int32))
        return h * 2, v, T

    _, v, _ = lax.while_loop(cond, body, (jnp.int32(1), v, T))
    return v


def _next_pos(mask, n: int):
    """e[x] = smallest y > x with mask[y], else n (reverse cummin, shifted)."""
    n1 = mask.shape[0]
    vals = jnp.where(mask, lax.iota(jnp.int32, n1), jnp.int32(n))
    revmin = lax.cummin(vals, reverse=True)
    return jnp.concatenate([revmin[1:], jnp.full((1,), jnp.int32(n))])


def _sais_ranks_small(data: jnp.ndarray) -> jnp.ndarray:
    n = data.shape[0]
    n1 = n + 1  # data' = data + [$] (the terminator-smallest virtual char)
    d = data.astype(jnp.int32)

    # --- types: first nonzero comparison sign to the right (S iff +1)
    cmp = jnp.concatenate(
        [jnp.sign(d[1:] - d[:-1]), jnp.array([-1, 1], jnp.int32)]
    )
    # reverse-scan operand order (probed on this jax build, round 5): ``b``
    # is the element NEARER the output index.  The a-preference form picks
    # the rightmost nonzero instead — every type came out S, no LMS
    # positions existed, and the capped windows silently ran to the string
    # end: still-correct ranks (cap-free windows degenerate to whole-string
    # doubling) but ~log2(n) joint-rank rounds per phase, which made this
    # the biggest program in the repo.  With first-to-the-RIGHT types the
    # round count is log2(max LMS gap) as designed.
    # A custom-combine associative_scan lowers to a log-depth
    # slice/pad/concat cascade whose compile time grows steeply with width;
    # if this path ever needs multi-MiB shapes, reformulate as marker
    # cumsum + compacted-value gather, as core/it2.py's merge does.
    filled = lax.associative_scan(
        lambda a, b: jnp.where(b != 0, b, a), cmp, reverse=True
    )
    t = filled > 0
    lms = jnp.concatenate([jnp.zeros((1,), jnp.bool_), t[1:] & ~t[:-1]])

    # (char,type) alphabet; sentinel symbol 1 below every real (u >= 2)
    u = jnp.concatenate([d * 2 + t[:n].astype(jnp.int32) + 2, jnp.ones((1,), jnp.int32)])
    e_lms = _next_pos(lms, n)
    is_l = ~t
    e_l = _next_pos(is_l, n)

    # --- naming: equal LMS substrings share a rank (terminal ref = 0)
    v_name = _capped_ranks(u, e_lms, lms, jnp.zeros((n1,), jnp.int32))

    # --- reduce + solve on the tuned doubling engine (static cap M)
    M = n1 // 2 + 1
    flag = jnp.where(lms, jnp.int32(0), jnp.int32(1))
    _, lpos, lname = lax.sort(
        (flag, lax.iota(jnp.int32, n1), v_name), num_keys=2
    )
    m = jnp.sum(lms.astype(jnp.int32))
    keep = lax.iota(jnp.int32, M) < m
    lpos = jnp.where(keep, lpos[:M], jnp.int32(-1))
    # names + 1 with constant-0 padding = small-sentinel semantics on the
    # reduced string (pad suffixes sort below all real ones; two real
    # suffixes can't enter the pad at the same offset)
    s1 = jnp.where(keep, lname[:M] + 1, jnp.int32(0))
    r_star = suffix_ranks_windows(s1, 1, SENT_SMALL)

    ref = jnp.zeros((n1,), jnp.int32).at[jnp.where(keep, lpos, n1)].set(
        jnp.where(keep, r_star, 0), mode="drop"
    )

    # --- induce: L ranks (caps at LMS with exact LMS-suffix terminals),
    # then S ranks (caps at L with the L-rank terminals)
    v_l = _capped_ranks(u, e_lms, lms, ref)
    v_s = _capped_ranks(u, e_l, is_l, v_l)

    cls = jnp.where(t[:n], v_s[:n], v_l[:n])
    key1 = u[:n]
    _, _, order = lax.sort((key1, cls, lax.iota(jnp.int32, n)), num_keys=2)
    return _invert_permutation(order, lax.iota(jnp.int32, n))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_ranks_sais(data: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    """Rank array (inverse SA) of ``data`` (uint8) via induced sorting."""
    n = data.shape[0]
    if n <= 1:
        return jnp.zeros((n,), jnp.int32)
    if sentinel == SENT_LARGE:
        # large-sentinel order = reversed small-sentinel order of the
        # complemented text
        return jnp.int32(n - 1) - _sais_ranks_small(jnp.uint8(255) - data)
    return _sais_ranks_small(data)


@functools.partial(jax.jit, static_argnames=("sentinel",))
def suffix_array_sais(data: jnp.ndarray, sentinel: str = SENT_SMALL) -> jnp.ndarray:
    n = data.shape[0]
    if n <= 1:
        return jnp.zeros((n,), jnp.int32)
    rank = suffix_ranks_sais(data, sentinel)
    return _invert_permutation(rank, lax.iota(jnp.int32, n))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def bwt_sais(data: jnp.ndarray, sentinel: str = SENT_SMALL):
    """Forward BWT via the induced-sorting path: returns (L, base)."""
    n = data.shape[0]
    if n <= 1:
        return data, jnp.int32(0)
    rank = suffix_ranks_sais(data, sentinel)
    prev = jnp.roll(data, 1)
    _, L = lax.sort((rank, prev), num_keys=1)
    return L, rank[0]
