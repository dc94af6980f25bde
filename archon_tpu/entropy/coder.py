"""Bit-stream pack/unpack for the a6 entropy stage (numpy host versions).

Semantics replicate a6/src/coder.c:
- ``encode_stream`` packs each symbol's code LSB-first at increasing bit
  offsets into 32-bit little-endian words (coder.c:108-123), so reading the
  stream *backward* from a codeword's end yields the code MSB-first — the
  orientation the suffix sort and decoder use.
- ``decode_stream`` is the 12-bit first-bits bucket decoder
  (coder_build_decoder/coder_decode_symbol, coder.c:130-209) expressed as a
  table walk; used for tests and the CLI unpack path.

The JAX vectorized bit-pack (prefix-sum of lengths + word scatter-OR)
lives in archon_tpu/ops/bitpack.py; these numpy forms are its oracle.
"""

from __future__ import annotations

import numpy as np

from .huffman import SymbolCode


def encode_stream(data: np.ndarray, codes: list[SymbolCode]) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack ``data`` (uint8 symbols) into a bit stream.

    Returns (stream_bytes, end_offsets, total_bits): end_offsets[j] is the
    bit offset just past symbol j's code (the sort positions of a6)."""
    lengths = np.array([codes[b].length for b in range(256)], np.int64)[data]
    values = np.array([codes[b].code for b in range(256)], np.uint64)[data]
    ends = np.cumsum(lengths)
    total = int(ends[-1]) if len(ends) else 0
    starts = ends - lengths

    # expand into a bit array (LSB of code at the start offset)
    bits = np.zeros(total, np.uint8)
    for j in range(len(data)):
        l = int(lengths[j])
        if l == 0:
            continue
        c = int(values[j])
        s = int(starts[j])
        for t in range(l):
            bits[s + t] = (c >> t) & 1
    nbytes = (total + 7) // 8
    stream = np.packbits(bits.reshape(-1), bitorder="little")
    stream = np.resize(stream, nbytes)
    return stream, ends.astype(np.int64), total


def bits_of_stream(stream: np.ndarray, total_bits: int) -> np.ndarray:
    """Unpack a byte stream into a uint8 bit array of length total_bits."""
    bits = np.unpackbits(stream, bitorder="little")
    return bits[:total_bits]


def decode_stream(stream: np.ndarray, total_bits: int, codes: list[SymbolCode], n: int) -> np.ndarray:
    """Decode n symbols from the bit stream (test/CLI path, not perf).

    The stream is *backward* decodable: each codeword's MSB sits at its end
    offset minus one, and greedy MSB-first matching from the end is unique by
    prefix-freeness (forward LSB-aligned matching would be ambiguous) — the
    same orientation the reference's suffix sort consumes (bwt.c:112-144)."""
    bits = bits_of_stream(stream, total_bits)
    table = {}
    for sym in range(256):
        sc = codes[sym]
        if sc.length:
            table[(sc.length, sc.code)] = sym
    out = np.zeros(n, np.uint8)
    pos = total_bits
    for j in range(n - 1, -1, -1):
        acc = 0
        l = 0
        while True:
            l += 1
            if l > 32 or l > pos:
                raise ValueError("undecodable stream")
            acc = (acc << 1) | int(bits[pos - l])
            sym = table.get((l, acc))
            if sym is not None:
                out[j] = sym
                pos -= l
                break
    return out
