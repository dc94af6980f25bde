"""Golden (oracle) suffix-array and BWT models, pure numpy.

These are the bit-exact reference emulators for the Archon family formats
(SURVEY.md section 7, layer 1).  They define the *semantics* each device path must
reproduce; speed is irrelevant here.

Format semantics (empirically validated against the compiled reference
binaries, see tests/test_golden_vs_reference.py):

a4 (reference: bwt/a4/src/archon.c:134-234, direct.c:167-178 ``compare``)
    Sorts positions x in 1..n by the *backward* read key
    ``in[x-1], in[x-2], ..., in[0]`` with end-of-string smaller than any byte
    (prefix ties resolve shorter-first).  Emits ``in[x]`` per sorted position
    (``in[n] := in[0]``), then the u32-LE rank of x == n ("base") last.
    Equivalently: the standard terminator-smallest BWT of the *reversed*
    input, with wrap-around emission for the full suffix.

a7 (reference: bwt/a7/src/archon.cpp:160-172 ``findLMS``, :887-900 ``enWrite``)
    Identical, except prefix ties resolve *longer*-first (end-of-string
    compares larger than any byte).  Equivalently the terminator-largest BWT
    of the reversed input.  NOTE: the reference binary segfaults on inputs
    that are monotonically non-increasing end-to-end (zero LMS positions);
    this golden model is still well-defined there and our framework handles
    those inputs.

Decode (reference: a4/src/archon.c:236-262 ``decode``;
        a7/src/archon.cpp:903-943 ``deCompute/deWrite``)
    LF successor table P[i] = bucket_start[L[i]]++ built in a specific
    *processing order* (a4 rolls the base index first; a7 rolls it last),
    then a chain walk from the base emits the original text.
"""

from __future__ import annotations

import numpy as np

SENT_SMALL = "small"  # end-of-string < every byte  (a4 convention)
SENT_LARGE = "large"  # end-of-string > every byte  (a7 convention)


def suffix_array(data: np.ndarray, sentinel: str = SENT_SMALL) -> np.ndarray:
    """Suffix array of ``data`` (uint8 array) by prefix doubling, O(n log^2 n).

    sentinel='small': on a prefix tie the shorter suffix sorts first
    (classic $-terminator semantics).
    sentinel='large': the longer suffix sorts first.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if sentinel not in (SENT_SMALL, SENT_LARGE):
        raise ValueError(f"bad sentinel {sentinel!r}")
    off_end = np.int64(-1) if sentinel == SENT_SMALL else np.int64(n + 0x100)
    rank = data.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        rank2 = np.where(idx + k < n, rank[np.minimum(idx + k, n - 1)], off_end)
        order = np.lexsort((rank2, rank))
        r_s, r2_s = rank[order], rank2[order]
        head = np.ones(n, dtype=np.int64)
        head[1:] = (r_s[1:] != r_s[:-1]) | (r2_s[1:] != r2_s[:-1])
        new_rank_sorted = np.cumsum(head) - 1
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1:
            return order
        k *= 2


def bwt_forward(data: bytes | np.ndarray, sentinel: str) -> tuple[np.ndarray, int]:
    """Terminator-convention BWT of ``data``: returns (L, base).

    L[i] = data[(sa[i]-1) mod n]; base = rank of the full suffix (sa==0).
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(arr)
    if n == 0:
        # Reference binaries refuse empty input (a4/src/archon.c:137); we
        # define the natural degenerate form: empty L, base 0.
        return np.zeros(0, dtype=np.uint8), 0
    sa = suffix_array(arr, sentinel)
    L = arr[(sa - 1) % n]
    base = int(np.nonzero(sa == 0)[0][0])
    return L, base


def _lf_successor(L: np.ndarray, order: np.ndarray) -> np.ndarray:
    """P[i] = bucket_start[L[i]] + (#j processed before i with L[j]==L[i]),
    where 'processed before' is defined by the permutation ``order``
    (order[t] = index processed at time t)."""
    n = len(L)
    counts = np.bincount(L, minlength=256)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    P = np.empty(n, dtype=np.int64)
    ctr = starts.copy()
    for i in order:
        c = L[i]
        P[i] = ctr[c]
        ctr[c] += 1
    return P


def bwt_inverse(L: np.ndarray, base: int, sentinel: str) -> np.ndarray:
    """Invert (L, base): returns the *reverse* of the pre-BWT string.

    Both reference decoders BWT the reversed input but walk the LF chain so
    that the original (unreversed) text is emitted directly; this function
    reproduces that walk, so ``bwt_inverse(bwt_forward(T)) == T[::-1]``.

    The processing order of the LF roll encodes the sentinel convention:
    a4 (small) rolls the base index first (a4/src/archon.c:255-257);
    a7 (large) rolls it last (a7/src/archon.cpp:929-931).
    The emitted walk is identical: k = base; emit L-source[k]; k = P[k].
    """
    n = len(L)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    rest = np.concatenate((np.arange(0, base), np.arange(base + 1, n)))
    if sentinel == SENT_SMALL:
        order = np.concatenate(([base], rest))
    else:
        order = np.concatenate((rest, [base]))
    P = _lf_successor(L, order)
    out = np.empty(n, dtype=np.uint8)
    k = base
    for i in range(n):
        out[i] = L[k]
        k = P[k]
    return out


# ---------------------------------------------------------------------------
# File formats: payload = L bytes then u32-LE base appended (both a4 and a7).
# ---------------------------------------------------------------------------

def a4_encode(data: bytes) -> bytes:
    """Byte-exact emulator of ``archon4r0 e`` (a4/src/archon.c:227-234)."""
    rev = data[::-1]
    L, base = bwt_forward(rev, SENT_SMALL)
    return L.tobytes() + np.uint32(base).tobytes()


def a4_decode(blob: bytes) -> bytes:
    """Byte-exact emulator of ``archon4r0 d`` (a4/src/archon.c:236-262)."""
    n = len(blob) - 4
    L = np.frombuffer(blob[:n], dtype=np.uint8)
    base = int(np.frombuffer(blob[n:], dtype=np.uint32)[0])
    # a4's decoder emits the original (unreversed) text directly: its chain
    # walk over the reversed-string BWT produces S without materializing R.
    return bwt_inverse(L, base, SENT_SMALL).tobytes()


def a7_encode(data: bytes) -> bytes:
    """Byte-exact emulator of ``archon7 e`` (a7/src/archon.cpp:887-900)."""
    rev = data[::-1]
    L, base = bwt_forward(rev, SENT_LARGE)
    return L.tobytes() + np.uint32(base).tobytes()


def a7_decode(blob: bytes) -> bytes:
    """Byte-exact emulator of ``archon7 d`` (a7/src/archon.cpp:903-943)."""
    n = len(blob) - 4
    L = np.frombuffer(blob[:n], dtype=np.uint8)
    base = int(np.frombuffer(blob[n:], dtype=np.uint32)[0])
    return bwt_inverse(L, base, SENT_LARGE).tobytes()
