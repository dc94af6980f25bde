"""IT-2 reduced-volume BWT (core/it2.py) — exactness vs the v3 production
path, both sentinel conventions, plus the exact-or-flagged contract on
pathological inputs (the reduced-sorted-volume structure)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")


def _check(arr, sent):
    from archon_tpu.core.fast2 import bwt_v3
    from archon_tpu.core.it2 import bwt_it2

    a = jnp.asarray(arr)
    L, b, ok = bwt_it2(a, sent)
    if not bool(ok):
        return "flagged"
    Lw, bw = bwt_v3(a, sent)
    assert (np.asarray(L) == np.asarray(Lw)).all()
    assert int(b) == int(bw)
    return "exact"


@pytest.mark.parametrize("sent", ["small", "large"])
def test_it2_matches_v3_on_corpora(sent):
    from archon_tpu.utils.corpus import markup_like, text_like

    assert _check(np.frombuffer(text_like(16384), np.uint8), sent) == "exact"
    assert _check(np.frombuffer(markup_like(16384), np.uint8), sent) == "exact"


@pytest.mark.parametrize("sent", ["small", "large"])
def test_it2_fuzz_random_families(sent):
    rng = np.random.default_rng(7)
    for trial in range(6):
        hi = int(rng.integers(3, 257))
        n = int(rng.integers(2, 6000))
        arr = rng.integers(0, hi, n).astype(np.uint8)
        _check(arr, sent)  # exact or flagged, never silently wrong


@pytest.mark.parametrize("sent", ["small", "large"])
def test_it2_gauntlet_exact_or_flagged(sent):
    from archon_tpu.utils.corpus import gauntlet_cases

    for name, g in gauntlet_cases(32768).items():
        _check(np.frombuffer(g, np.uint8), sent)


def test_it2_edges():
    for data in (b"", b"a", b"ba", b"ab", b"aaaa", b"banana"):
        arr = np.frombuffer(data, np.uint8)
        for sent in ("small", "large"):
            _check(arr, sent)


def test_container_it2_impl_roundtrip(tmp_path):
    """--impl it2 routes blocks through the reduced-volume path with
    automatic v3 fallback; containers stay byte-identical with the
    streamed path (same format, same per-block L/base)."""
    from archon_tpu.io import blocks
    from archon_tpu.utils.corpus import gauntlet_cases, text_like

    data = text_like(5 * 8192, seed=13)
    a = blocks.encode_file(data, "a4", block_size=8192, impl="it2")
    b = blocks.encode_file(data, "a4", block_size=8192, impl="stream")
    assert a == b
    assert blocks.decode_file(a) == data
    # a fallback-forcing block (giant zero run) still round-trips
    g = gauntlet_cases(8192)["zeros"] + text_like(8192, seed=14)
    blob = blocks.encode_file(g, "a4", block_size=8192, impl="it2")
    assert blocks.decode_file(blob) == g
