"""Distributed (sharded megablock) suffix sort vs golden, on the CPU mesh."""

import numpy as np
import pytest

from archon_tpu.parallel.blocks import make_mesh
from archon_tpu.parallel.megablock import suffix_array_sharded
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import text_like, gauntlet_cases


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_sharded_matches_golden(sentinel):
    mesh = make_mesh({"sp": 8})
    rng = np.random.default_rng(17)
    cases = [
        np.frombuffer(text_like(4096), np.uint8),
        rng.integers(0, 4, 2048, dtype=np.uint8),
        rng.integers(0, 256, 4096, dtype=np.uint8),
        np.frombuffer(gauntlet_cases(2048)["fibonacci"], np.uint8),
        np.zeros(2048, np.uint8),  # one tie group spanning every shard
    ]
    for arr in cases:
        want = golden.suffix_array(arr, sentinel)
        got = suffix_array_sharded(arr, mesh, sentinel)
        assert got.tolist() == want.tolist(), f"{sentinel} n={len(arr)}"


def test_sharded_odd_sizes_and_two_shards():
    import jax

    mesh = make_mesh({"sp": 2}, devices=jax.devices()[:2])
    arr = np.frombuffer(text_like(1 << 10, seed=3), np.uint8)
    want = golden.suffix_array(arr, "small")
    got = suffix_array_sharded(arr, mesh, "small")
    assert got.tolist() == want.tolist()


def test_sharded_bwt_emission():
    """bwt_megablock: the prev-byte payload carried through the final
    merge-split sort must reproduce the golden BWT exactly, sharded."""
    from archon_tpu.parallel.megablock import bwt_megablock

    mesh = make_mesh({"sp": 8})
    for arr in (
        np.frombuffer(text_like(4096, seed=5), np.uint8),
        np.zeros(2048, np.uint8),
    ):
        L, base = bwt_megablock(arr, mesh, "small")
        want_L, want_base = golden.bwt_forward(arr, "small")
        assert np.asarray(L).tolist() == want_L.tolist()
        assert base == int(want_base)


@pytest.mark.parametrize("coder", ["byte", "var"])
@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_megapipe_roundtrip(coder, generation):
    """End-to-end sharded pipeline (BASELINE config 5's shape): SA -> sharded
    BWT -> per-shard Huffman pack -> container -> host decode -> original."""
    from archon_tpu.parallel.megapipe import decode_megablock, encode_megablock

    mesh = make_mesh({"sp": 8})
    data = text_like(8192, seed=9)
    blob = encode_megablock(data, mesh, generation, coder)
    assert decode_megablock(blob) == data
    if coder == "var":
        # entropy stage must actually compress text
        assert len(blob) < len(data)


def test_megapipe_degenerate_alphabet():
    from archon_tpu.parallel.megapipe import decode_megablock, encode_megablock

    mesh = make_mesh({"sp": 8})
    data = bytes(np.zeros(2048, np.uint8))  # single-symbol: zero-length codes
    blob = encode_megablock(data, mesh, "a4", "var")
    assert decode_megablock(blob) == data


def test_dynamic_round_matches_static():
    """The k-dynamic round program (one compile for all k) must produce the
    same ranks as the per-k static program."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    from archon_tpu.parallel.megablock import (
        _make_init, _make_round, _make_round_dyn,
    )

    mesh = make_mesh({"sp": 8})
    n, ns = 2048, 8
    S = n // ns
    arr = np.frombuffer(text_like(n, seed=13), np.uint8)
    data_dev = jax.device_put(
        jnp.asarray(arr), NamedSharding(mesh, P("sp"))
    )
    rank, _ = _make_init(mesh, S, n, "small")(data_dev)
    dyn = _make_round_dyn(mesh, S, n, "small")
    for k in (3, 12, 48, 192, 768):
        want_rank, want_na = _make_round(mesh, S, n, k, "small")(rank)
        got_rank, got_na = dyn(rank, jnp.int32(k))
        np.testing.assert_array_equal(np.asarray(got_rank), np.asarray(want_rank))
        assert int(got_na) == int(want_na)
        rank = want_rank


@pytest.mark.parametrize("name", ["zeros", "fibonacci"])
def test_sharded_gauntlet_large(name):
    """Shard-spanning tie groups at n >= 2^20 complete (a splitter-based
    partitioner aborts here).  Exactness vs golden."""
    n = 1 << 20
    mesh = make_mesh({"sp": 8})
    if name == "zeros":
        arr = np.zeros(n, np.uint8)
    else:
        arr = np.frombuffer(gauntlet_cases(n)["fibonacci"], np.uint8)[:n]
    want = golden.suffix_array(arr, "small")
    got = suffix_array_sharded(arr, mesh, "small")
    np.testing.assert_array_equal(got, want)
