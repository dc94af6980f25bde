"""JAX core vs golden models (runs on CPU; same code runs on the GPU)."""

import numpy as np
import jax.numpy as jnp
import pytest

from archon_tpu.golden import sa as golden
from archon_tpu.core.doubling import suffix_array, SENT_SMALL, SENT_LARGE
from archon_tpu.core.bwt import bwt_forward, verify_sa
from archon_tpu.core.unbwt import bwt_inverse
from archon_tpu import formats
from archon_tpu.utils.corpus import gauntlet_cases


def _cases():
    # JAX jit compiles per shape: keep the set of distinct lengths small so
    # the compile cache is reused across contents.
    rng = np.random.default_rng(123)
    out = [
        b"banana", b"mississippi", b"abab", b"aab", b"a", b"ab", b"aaa",
        b"bacbabcabab", b"\x00\x00\x01\x00", b"abcabcabc",
    ]
    for n in (64, 256):
        for _ in range(6):
            alpha = int(rng.integers(2, 257))
            out.append(bytes(rng.integers(0, alpha, n, dtype=np.uint8)))
    out += [v[:256] for v in gauntlet_cases(256).values()]
    return out


CASES = _cases()


@pytest.mark.parametrize("sentinel", [SENT_SMALL, SENT_LARGE])
def test_suffix_array_matches_golden(sentinel):
    for data in CASES:
        arr = np.frombuffer(data, dtype=np.uint8)
        want = golden.suffix_array(arr, sentinel)
        got = np.asarray(suffix_array(jnp.asarray(arr), sentinel))
        assert got.tolist() == want.tolist(), f"{sentinel} SA mismatch on {data[:30]!r} n={len(data)}"


@pytest.mark.parametrize("sentinel", [SENT_SMALL, SENT_LARGE])
def test_verify_sa(sentinel):
    data = np.frombuffer(b"yabbadabbadoo_yabba", dtype=np.uint8)
    arr = jnp.asarray(data)
    L, base, sa = bwt_forward(arr, sentinel)
    assert bool(verify_sa(arr, sa, sentinel))
    # corrupt it -> must fail
    bad = sa.at[3].set(sa[5]).at[5].set(sa[3])
    assert not bool(verify_sa(arr, bad, sentinel))
    # non-permutation -> must fail
    assert not bool(verify_sa(arr, sa.at[0].set(sa[1]), sentinel))


@pytest.mark.parametrize("sentinel", [SENT_SMALL, SENT_LARGE])
def test_inverse_matches_golden_and_roundtrips(sentinel):
    for data in CASES[:20]:
        arr = np.frombuffer(data, dtype=np.uint8)
        L_g, base_g = golden.bwt_forward(arr, sentinel)
        want = golden.bwt_inverse(L_g, base_g, sentinel)
        got = np.asarray(bwt_inverse(jnp.asarray(L_g), jnp.int32(base_g), sentinel))
        assert got.tolist() == want.tolist()
        # full on-device round trip
        L, base, _ = bwt_forward(jnp.asarray(arr), sentinel)
        rt = np.asarray(bwt_inverse(L, base, sentinel))
        assert rt.tolist() == arr[::-1].tolist()


@pytest.mark.parametrize("sentinel", [SENT_SMALL, SENT_LARGE])
def test_inverse_blocked_walk_large(sentinel):
    """n > 2*_WALK_K exercises the blocked K-chain cycle walk (the small-n
    branch is plain doubling); exactness vs golden on a 20 KiB block."""
    from archon_tpu.utils.corpus import text_like

    arr = np.frombuffer(text_like(20011, seed=13), np.uint8)
    L_g, base_g = golden.bwt_forward(arr, sentinel)
    got = np.asarray(bwt_inverse(jnp.asarray(L_g), jnp.int32(base_g), sentinel))
    want = golden.bwt_inverse(L_g, base_g, sentinel)
    assert got.tolist() == want.tolist()


def test_formats_match_golden():
    for data in CASES[:25]:
        assert formats.encode(data, "a4") == golden.a4_encode(data)
        assert formats.encode(data, "a7") == golden.a7_encode(data)
        assert formats.decode(formats.encode(data, "a4"), "a4") == data
        assert formats.decode(formats.encode(data, "a7"), "a7") == data


def test_formats_against_reference(oracles):
    """End-to-end interop of the JAX path with the compiled reference."""
    from conftest import run_oracle

    # varied text: the reference a7 segfaults on repetition-heavy inputs
    from archon_tpu.utils.corpus import text_like

    data = text_like(1500)
    for gen in ("a4", "a7"):
        if gen not in oracles:
            continue
        blob = formats.encode(data, gen)
        assert run_oracle(oracles[gen], "d", blob) == data
        ref_blob = run_oracle(oracles[gen], "e", data)
        assert formats.decode(ref_blob, gen) == data
