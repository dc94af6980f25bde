"""Data-parallel induced-sorting path (core/sais_tpu) vs golden, both conventions."""

import numpy as np
import pytest

from archon_tpu.core.sais_tpu import bwt_sais, suffix_array_sais, suffix_ranks_sais
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases, text_like


def _cases():
    rng = np.random.default_rng(0xA15)
    out = {
        "text": np.frombuffer(text_like(3000), np.uint8),
        "rand": rng.integers(0, 256, 2048, dtype=np.uint8),
        "small_alpha": rng.integers(0, 3, 1500, dtype=np.uint8),
        "tiny": np.frombuffer(b"mississippi", np.uint8),
        "two": np.frombuffer(b"ab", np.uint8),
        "one": np.frombuffer(b"z", np.uint8),
        "incr": np.arange(200, dtype=np.uint8),
        "decr": np.arange(200, dtype=np.uint8)[::-1].copy(),
    }
    for name, blob in gauntlet_cases(1024).items():
        out[f"g_{name}"] = np.frombuffer(blob, np.uint8)
    return out


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_sais_matches_golden(sentinel):
    for name, arr in _cases().items():
        want_sa = golden.suffix_array(arr, sentinel)
        got_sa = np.asarray(suffix_array_sais(arr, sentinel))
        assert got_sa.tolist() == want_sa.tolist(), f"{sentinel} {name}"


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_sais_bwt_matches_golden(sentinel):
    for name, arr in list(_cases().items())[:4]:
        if len(arr) < 2:
            continue
        want_L, want_base = golden.bwt_forward(arr, sentinel)
        L, base = bwt_sais(arr, sentinel)
        assert int(base) == int(want_base), f"{sentinel} {name}"
        assert np.asarray(L).tolist() == want_L.tolist(), f"{sentinel} {name}"


def test_sais_fuzz_small():
    # n is bucketed to three sizes on purpose: each distinct n compiles a
    # separate (large, recursive) XLA program, and ~120 of them in one
    # process exhausted XLA:CPU's JIT (suite-wide segfaults/aborts in
    # backend_compile).  Content still varies per iteration.
    rng = np.random.default_rng(3)
    for _ in range(20):
        for n in (5, 61, 119):
            alpha = int(rng.integers(1, 7))
            arr = rng.integers(0, alpha, n, dtype=np.uint8)
            for sentinel in ("small", "large"):
                want = golden.suffix_array(arr, sentinel)
                got = np.asarray(suffix_array_sais(arr, sentinel))
                assert got.tolist() == want.tolist(), (sentinel, arr.tolist())


def test_sais_ranks_are_permutation():
    arr = np.frombuffer(text_like(4096, seed=5), np.uint8)
    r = np.asarray(suffix_ranks_sais(arr, "small"))
    assert np.array_equal(np.sort(r), np.arange(len(arr)))
