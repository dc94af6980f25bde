"""JAX a6 path vs golden emulator (CPU)."""

import numpy as np
import pytest

from archon_tpu.core import a6 as j6
from archon_tpu.golden import a6 as g6
from archon_tpu.utils.corpus import text_like


def _cases():
    rng = np.random.default_rng(0x66)
    out = [b"banana", b"abracadabra alakazam", text_like(997)]
    for _ in range(3):
        out.append(bytes(rng.integers(0, 50, 256, dtype=np.uint8)))
    return out


@pytest.mark.parametrize("cfg", ["byte", "fix", "var"])
def test_jax_a6_matches_golden(cfg):
    for data in _cases():
        try:
            want = g6.a6_encode(data, cfg)
        except ValueError:
            continue
        got = j6.a6_encode(data, cfg)
        assert got == want, f"{cfg} n={len(data)}"
        assert j6.a6_decode(got, cfg) == data


def test_jax_a6_var_scales():
    """The var bit domain is sized by the table's true max code length, so
    realistic file sizes are traceable: golden-exact at 128 KiB, roundtrip
    at 1 MiB."""
    data = text_like(1 << 17)
    assert j6.a6_encode(data, "var") == g6.a6_encode(data, "var")
    big = text_like(1 << 20)
    blob = j6.a6_encode(big, "var")
    assert j6.a6_decode(blob, "var") == big


def _hostile_cases():
    """Inputs aimed at the symbol-reduction's edge cases: all-ones
    codewords, runs entering the TERMIN tail, tiny/duplicated-length
    alphabets, markup skeleton repeats."""
    from archon_tpu.utils.corpus import markup_like

    rng = np.random.default_rng(0xA6)
    out = [
        b"\xff" * 300,                      # all-0xFF: tail-equal comparisons
        b"\xff" * 120 + b"\x00" * 120,      # ones run ending at the stream head
        b"ab" * 200 + b"a",                 # 2-symbol: codes {0, 1} — the '1'
                                            # code IS the all-ones codeword
        b"aab" * 150,                       # skewed 2/3-symbol Huffman
        bytes(rng.integers(0, 3, 700, dtype=np.uint8)),
        bytes(rng.integers(250, 256, 500, dtype=np.uint8)),
        markup_like(3000),
        text_like(2500) + b"\xff" * 64,     # text entering an all-ones tail
    ]
    return out


@pytest.mark.parametrize("cfg", ["fix", "var"])
def test_symbol_reduction_equals_bit_domain(cfg):
    """The n-symbol dispatch (dense codeword-order remap) must be
    bit-for-bit identical with the literal bit-domain sort — the theorem
    _symbol_rank_map's docstring states, regression-tested on the hostile
    family plus the golden oracle where it accepts the config."""
    for data in _hostile_cases():
        sym_out, sym_base = j6.a6_forward(
            np.frombuffer(data, np.uint8), cfg, impl="symbol"
        )
        bit_out, bit_base = j6.a6_forward(
            np.frombuffer(data, np.uint8), cfg, impl="bits"
        )
        assert sym_base == bit_base, f"{cfg} n={len(data)} base"
        assert sym_out.tobytes() == bit_out.tobytes(), f"{cfg} n={len(data)}"
        try:
            want = g6.a6_encode(data, cfg)
        except ValueError:
            continue
        assert j6.a6_encode(data, cfg) == want
