"""Alphabet reorder heuristics (entropy/order.py vs a6/src/order.c) and the
wired -o path."""

import numpy as np
import pytest

from archon_tpu.entropy import order as O


def _order_init_scalar(data):
    """The reference loop verbatim (order.c:34-44) as the oracle for the
    vectorized order_init."""
    R2 = np.zeros((256, 256), np.int64)
    b = c = 0xFF
    for a in np.asarray(data, np.uint8).tolist():
        if a != b:
            c = b
            b = a
        R2[a][c] += 1
    return R2


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"a",
        b"\xff\xffabab\xff",
        b"aaabbbcccaaa",
        bytes(np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8)),
        bytes(np.random.default_rng(1).integers(0, 4, 5000, dtype=np.uint8)),
    ],
)
def test_order_init_matches_scalar(data):
    arr = np.frombuffer(data, np.uint8)
    assert (O.order_init(arr) == _order_init_scalar(arr)).all()


def test_order_none_identity():
    dc = np.arange(256, dtype=np.int64)
    assert (O.order_none(np.zeros((256, 256), np.int64), dc) == dc).all()


def test_order_freq_hand_computed():
    # 'b' appears most, then 'a', then 'c'; ties (all zero-count symbols)
    # keep their original relative order (stable sort)
    data = np.frombuffer(b"abbbab" + b"c", np.uint8)
    dc = O.order_freq(O.order_init(data), np.arange(256, dtype=np.int64))
    assert dc[0] == ord("b") and dc[1] == ord("a") and dc[2] == ord("c")
    assert sorted(dc.tolist()) == list(range(256))


def test_order_bubble_no_improving_adjacent_swap():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 8, 4000, dtype=np.uint8)
    R2 = O.order_init(data)
    dc = O.order_bubble(R2, np.arange(256, dtype=np.int64))
    assert sorted(dc.tolist()) == list(range(256))
    # fixed point of the relaxation: no adjacent pair still wants to swap
    for i in range(255):
        c0, c1 = dc[i], dc[i + 1]
        assert int(R2[c1][c0]) - int(R2[c0][c1]) <= 0


@pytest.mark.parametrize("name", ["freq", "greedy", "topo", "bubble"])
def test_order_heuristics_permutation_and_deterministic(name):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 32, 6000, dtype=np.uint8)
    fn = O.ORDER_FUNCTIONS[name]
    a = fn(O.order_init(data), np.arange(256, dtype=np.int64))
    b = fn(O.order_init(data), np.arange(256, dtype=np.int64))
    assert sorted(np.asarray(a).tolist()) == list(range(256))
    assert np.asarray(a).tolist() == np.asarray(b).tolist()


def test_order_table_permutation_all():
    data = np.frombuffer(b"the quick brown fox jumps over the lazy dog" * 40, np.uint8)
    for name in ("none", "freq", "greedy", "topo", "bubble"):
        dc = O.order_table(data, name)
        assert dc.dtype == np.uint8
        assert sorted(dc.tolist()) == list(range(256))
    with pytest.raises(ValueError):
        O.order_table(data, "matrix")


@pytest.mark.parametrize("coder", ["byte", "var"])
@pytest.mark.parametrize("name", ["freq", "bubble"])
def test_a6_order_roundtrip(coder, name):
    from archon_tpu.core.a6 import a6_decode, a6_encode

    from archon_tpu.utils.corpus import text_like

    data = text_like(30000)
    blob = a6_encode(data, coder, order=name)
    # extension blob is SELF-DESCRIBING: magic, then the table
    assert blob[:4] == b"AO1\xff"
    dc = np.frombuffer(blob[4:260], np.uint8)
    assert sorted(dc.tolist()) == list(range(256))
    # decode needs NO out-of-band order argument
    assert a6_decode(blob, coder) == data
    assert a6_decode(blob, coder, order=name) == data
    # the none default stays the plain (reference-shaped) blob, and a
    # stated-order mismatch on a plain blob fails loudly
    plain = a6_encode(data, coder)
    assert len(plain) == 4 + len(data)
    with pytest.raises(ValueError):
        a6_decode(plain, coder, order=name)


def test_cli_order_flag_roundtrip(tmp_path):
    from archon_tpu.cli import main
    from archon_tpu.utils.corpus import text_like

    data = text_like(20000)
    src = tmp_path / "in.bin"
    enc = tmp_path / "out.a6"
    dec = tmp_path / "back.bin"
    src.write_bytes(data)
    assert main(["a6", str(src), str(enc), "-c", "var", "-o", "freq"]) == 0
    assert main(["a6", str(enc), str(dec), "-c", "var", "-o", "freq", "-u"]) == 0
    assert dec.read_bytes() == data
