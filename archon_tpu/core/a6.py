"""JAX path for the a6 generation: entropy-recoded BWT over bit offsets.

The a6 transform sorts codeword end offsets of the bit-packed stream by
backward bit reading (golden/a6.py documents the full derivation).  Here the
reversed bit string is sorted with the same prefix-doubling core as the byte
path, seeded with 16-bit windows so the bit-level doubling starts at k=16.

Code tables come from the exact host-side Huffman/fixed builders
(entropy/huffman.py) — O(256^2) host work, negligible; everything after the
table build is jit-compiled.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..entropy.huffman import (
    build_encoder_byte,
    build_encoder_fixed,
    build_encoder_var,
)
from ..ops.bitpack import pack_codes_sized, words_to_bits
from .doubling import SENT_LARGE
from .fast2 import bwt_v3_payload, suffix_ranks_windows
from .unbwt import bwt_inverse

TERMIN_BITS = 80


def _check_code_lengths(codes) -> None:
    """Both code paths assume codeword length <= 32 (the reference's
    MAX_CODE_LENGTH, a6/src/coder.c:18): ``_symbol_rank_map`` shifts by
    (32 - length), and the packer's u32-word stream cannot hold a longer
    code.  A Huffman depth > 32 is achievable with a skewed ~9+ MB input
    (Fibonacci-like weights); numpy would evaluate the negative shift
    SILENTLY (np.int64 << -1 == 0), corrupting the rank map — fail loudly
    instead."""
    worst = max(c.length for c in codes)
    if worst > 32:
        raise ValueError(
            f"Huffman code length {worst} exceeds the 32-bit format limit "
            "(MAX_CODE_LENGTH); this input's symbol distribution is too "
            "skewed for the a6 format"
        )


def _code_arrays(codes):
    _check_code_lengths(codes)
    vals = np.array([c.code for c in codes], np.uint32)
    lens = np.array([c.length for c in codes], np.int32)
    return jnp.asarray(vals), jnp.asarray(lens)


def _uniform_width(codes, freq) -> int:
    """Code width W if every *present* symbol has the same length <= 8,
    else 0.  Uniform-width streams take the symbol-domain fast path."""
    lens = {codes[i].length for i in range(256) if freq[i]}
    if len(lens) == 1:
        (w,) = lens
        if 1 <= w <= 8:
            return w
    return 0


def _symbol_rank_map(codes) -> np.ndarray:
    """Dense symbol order under MSB-first codeword comparison — the map that
    reduces the VAR bit-domain sort to an n-symbol sort.

    Why this is exact for any prefix-free table (not just uniform widths):
    the suffix of the reversed bit stream at codeword-end position sel_i is
    the MSB-first codeword of data[i], then data[i-1], ...  Prefix-freeness
    means two DIFFERENT codewords differ strictly within min(len) bits, so a
    bit comparison between two selected suffixes always resolves inside the
    first differing symbol — i.e. at symbol granularity, under the order of
    left-aligned codeword values (the same keys the decoder buckets by).
    Equal symbols consume equal bits and recurse to the next symbol, exactly
    like a symbol-domain suffix comparison.  The TERMIN-ones tail behaves as
    the SENT_LARGE off-end sentinel: any key above an all-ones codeword's
    key would need that codeword as a prefix (excluded), so the all-ones
    codeword (if present) holds the maximal rank and the shorter-is-larger
    tail convention matches the sentinel — the same argument the
    uniform-width path verified against the golden oracle (all-0xFF, tiny
    alphabets), now applied per-symbol.  Ref: the reference instead radix
    sorts raw bit offsets (a6/src/bwt.c:367-402) because its fixed-width
    radix keys must span codeword boundaries; a comparison-exact sorter
    never needs the bit domain at all."""
    _check_code_lengths(codes)
    keys = np.full(256, np.iinfo(np.int64).max, np.int64)
    for s in range(256):
        if codes[s].length:
            keys[s] = np.int64(codes[s].code) << (32 - codes[s].length)
    order = np.argsort(keys, kind="stable")
    rank_map = np.empty(256, np.uint8)
    rank_map[order] = np.arange(256, dtype=np.uint8)
    return rank_map


def build_codes(data: np.ndarray, config: str):
    freq = np.bincount(data, minlength=256)
    if config == "byte":
        return build_encoder_byte()
    if config == "fix":
        return build_encoder_fixed(freq)[0]
    if config == "var":
        return build_encoder_var(freq)
    raise ValueError(f"bad a6 config {config!r}")


def _bit_suffix_ranks(rev_padded: jnp.ndarray):
    """Rank all suffixes of the padded reversed bit string (uint8 0/1 values,
    TERMIN ones appended; off-end sentinel large).

    Seeds 16-position windows into the measurement-tuned v3 pipeline (the
    bootstrap covers context 64 in one 4-key sort, then quadrupling rounds
    and the narrowed cascade).  Windows are BASE-3 digit packs with an
    explicit off-end digit 2 — NOT 1-padded bit packs: a 1-pad erases the
    string-end boundary inside a trailing all-ones run, leaving distinct
    tail suffixes window-identical at every offset, and the quadrupling
    shifts (k, 2k, 3k) then never land exactly on the length boundary that
    separates them — adjacent TERMIN-tail positions stayed tied forever and
    poisoned every rank read through them (caught by the symbol-reduction
    equivalence fuzz, round 4).  Digit 2 > any real bit is precisely the
    SENT_LARGE per-position convention; 3^16 < 2^31 keeps the pack in
    int32."""
    m = rev_padded.shape[0]
    ext = jnp.concatenate(
        [rev_padded.astype(jnp.int32), jnp.full((16,), 2, jnp.int32)]
    )
    win = jnp.zeros((m,), jnp.int32)
    for t in range(16):
        win = win * 3 + ext[t : m + t]
    return suffix_ranks_windows(win, 16, SENT_LARGE)


@functools.partial(jax.jit, static_argnames=("max_len",))
def _a6_transform(data: jnp.ndarray, code_values: jnp.ndarray,
                  code_lengths: jnp.ndarray, max_len: int = 32):
    """Jitted a6 forward, variable-width path: pack, bit-sort over the
    reversed stream, select codeword ends, emit.

    ``max_len`` is the table's TRUE maximum code length — host-known before
    trace time (the Huffman build is host-side) — so the static bit domain
    is ~max_len*n instead of the 32n worst case.
    The reference bounds its key domain by real code widths the same way
    (rad_bits <= 24, a6/src/bwt.c:346)."""
    n = data.shape[0]
    words, ends, total = pack_codes_sized(data, code_values, code_lengths, max_len)
    bits = words_to_bits(words)  # static capacity; only [0, total) is real

    m_cap = bits.shape[0] + TERMIN_BITS
    # reversed stream: rev[i] = bits[total-1-i] for i < total; then TERMIN
    # ones; beyond that (static padding region) ones as well — harmless
    # because only suffixes at selected positions < total are consumed.
    iota_m = lax.iota(jnp.int32, m_cap)
    src = total - 1 - iota_m
    rev = jnp.where(
        src >= 0, bits[jnp.clip(src, 0, bits.shape[0] - 1)], jnp.uint8(1)
    )
    rank = _bit_suffix_ranks(rev)

    sel = total - ends  # reversed positions of codeword ends (all >= 0)
    key = rank[sel]
    # emission with carried payload: out[slot] = data[(order[slot]+1) % n]
    # rides the sort instead of a random gather
    nxt = jnp.roll(data, -1)
    _, out = lax.sort((key, nxt), num_keys=1)
    # sel == 0 iff i == n-1 (ends[n-1] == total); its slot among the n
    # selected keys is the count of smaller keys (bit-domain ranks are
    # unique but not dense over the selection)
    base = jnp.sum((key < key[n - 1]).astype(jnp.int32))
    return out, base


def _remap256(c: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """256-entry byte remap WITHOUT a gather: one-hot compare + masked sum,
    which XLA fuses row-wise into one reduction.  Whether it beats plain
    ``table[c]`` depends on the device's gather cost
    (scripts/measure_r5.py gather256 compares the two)."""
    i = jnp.arange(256, dtype=jnp.uint8)
    return jnp.sum(
        jnp.where(c[:, None] == i[None, :], table[None, :], jnp.uint8(0)),
        axis=1,
    )


@jax.jit
def _a6_symbol_transform(data: jnp.ndarray, code_map: jnp.ndarray):
    """Jitted a6 forward, n-symbol path (every prefix-free table, via the
    symbol-reduction theorem of ``_symbol_rank_map``).

    The bit-suffix order over codeword-end positions equals the SENT_LARGE
    suffix order of the *recoded reversed text* s[j] = code_rank(data[n-1-j])
    — n symbols instead of ~max_len*n bits, running on the tuned byte-domain
    sorter.  (The TERMIN-ones tail compares identically to the sentinel-large
    convention: any suffix entering the tail reads all-ones codes then
    off-end-large, which orders shorter-is-larger exactly like the immediate
    sentinel; fuzz-verified against the literal bit-domain oracle.)

    This runs the full v3 structure (deferred inversions,
    carried payload, micro tail) via ``bwt_v3_payload``: the emitted byte is
    the next ORIGINAL byte in s-space — payload[j] = data[(n-j) mod n] =
    roll(reversed data, 1)[j] — so the BWT comes straight out of the last
    sort with no separate full-width emission sort, and base = rank_s[0]
    (the full s-suffix is symbol i == n-1) falls out as the v3 base of
    position 0.  Ref: a6's radix-over-bit-keys design bwt.c:367-402."""
    rev = data[::-1]
    s = _remap256(rev, code_map)
    payload = jnp.roll(rev, 1)
    return bwt_v3_payload(s, payload, SENT_LARGE)


def a6_forward(data: bytes | np.ndarray, config: str = "byte",
               impl: str = "symbol"):
    """a6 transform of ``data``; returns (payload bytes array, base).

    Every prefix-free table — byte, fix, AND var/Huffman — dispatches to the
    n-symbol fast path through the dense codeword-order remap
    (``_symbol_rank_map``): the bit-domain sort is provably equivalent at
    symbol granularity.  ``impl="bits"`` forces the literal bit-domain path
    (kept as the independent oracle the equivalence is regression-tested
    against; also the route for the degenerate single-symbol table whose
    codes are zero-length)."""
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    if len(arr) == 0:
        return np.zeros(0, np.uint8), 0
    codes = build_codes(arr, config)
    freq = np.bincount(arr, minlength=256)
    all_coded = all(codes[i].length for i in range(256) if freq[i])
    if impl == "symbol" and all_coded:
        out, base = _a6_symbol_transform(
            jnp.asarray(arr), jnp.asarray(_symbol_rank_map(codes))
        )
    else:
        vals, lens = _code_arrays(codes)
        max_len = max((codes[i].length for i in range(256) if freq[i]),
                      default=1)
        out, base = _a6_transform(jnp.asarray(arr), vals, lens,
                                  max_len=max(int(max_len), 1))
    return np.asarray(out), int(base)


# Extension-blob magic for order-remapped output.  Self-describing on
# purpose: its little-endian u32 value 0xFF314F41 exceeds any
# valid base index (the format caps blocks at 2^30, a6/src/bwt.c:249), so a
# plain blob — which starts with the u32 base — can never alias it.
_ORDER_MAGIC = b"AO1\xff"


def a6_encode(data: bytes, config: str = "byte", order: str = "none") -> bytes:
    """a6-format blob (u32-LE base first, then N payload bytes).

    ``order`` != "none" remaps the alphabet through the chosen heuristic
    (entropy/order.py; the reference parses ``-o`` but never applies it,
    a6/src/main.c:33-41 / bwt.c:69-77) before the transform.  The remapped
    blob is an EXTENSION format: magic ``AO1\\xff``, then a 256-byte
    destination table, then the plain blob — self-describing, so decode
    needs no out-of-band order flag (the ``none`` default stays byte-exact
    with the reference binary)."""
    if order == "none":
        out, base = a6_forward(data, config)
        return np.uint32(base).tobytes() + out.tobytes()
    from ..entropy.order import order_table

    arr = np.frombuffer(bytes(data), np.uint8)
    dc = order_table(arr, order)
    inv = np.empty(256, np.uint8)
    inv[dc] = np.arange(256, dtype=np.uint8)
    out, base = a6_forward(inv[arr], config)
    return _ORDER_MAGIC + dc.tobytes() + np.uint32(base).tobytes() + out.tobytes()


def a6_decode(blob: bytes, config: str = "byte", order: str | None = None) -> bytes:
    """Invert an a6 blob.  Order-remapped blobs self-identify via their
    magic; ``order`` is accepted for backward compatibility and only
    validated — a mismatch between the stated order and what the blob
    actually is raises instead of silently decoding garbage."""
    is_ordered = blob[:4] == _ORDER_MAGIC
    if order is not None and order != "none" and not is_ordered:
        raise ValueError(
            f"order={order!r} requested but the blob has no order table "
            "(plain a6 format)"
        )
    if is_ordered:
        dc = np.frombuffer(blob[4:260], np.uint8)
        inner = _a6_decode_raw(blob[260:], config)
        return dc[np.frombuffer(inner, np.uint8)].tobytes()
    return _a6_decode_raw(blob, config)


def _a6_decode_raw(blob: bytes, config: str = "byte") -> bytes:
    """Invert an a6 blob on device (byte/fix); var uses code-ordered buckets
    (correct inverse; the reference's -u is broken for var, see golden/a6.py)."""
    base = int(np.frombuffer(blob[:4], np.uint32)[0])
    L = np.frombuffer(blob[4:], np.uint8)
    if len(L) == 0:
        return b""
    if config in ("byte", "fix"):
        out = bwt_inverse(jnp.asarray(L), jnp.int32(base), SENT_LARGE)
        return np.asarray(out).tobytes()
    # var: rebuild the Huffman table from the payload histogram (the BWT is
    # a permutation, so frequencies match the original) and walk with
    # code-ordered bucket starts — the correct inverse the reference lacks
    # (its -u uses byte-ordered buckets; see golden/a6.py).  The walk runs
    # on the native host runtime's segmented MLP walk.
    from .. import native

    codes = build_encoder_var(np.bincount(L, minlength=256))
    keys = np.array(
        [
            (codes[c].code << (32 - codes[c].length)) if codes[c].length else -1
            for c in range(256)
        ],
        np.int64,
    )
    counts = np.bincount(L, minlength=256)
    starts = np.zeros(256, np.int64)
    acc = 0
    for c in np.argsort(keys, kind="stable"):
        starts[c] = acc
        acc += int(counts[c])
    return native.unbwt_starts(L, base, starts).tobytes()
