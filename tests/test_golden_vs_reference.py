"""Fuzz the numpy golden models against the compiled reference binaries.

This is the anchor of the whole test pyramid (SURVEY.md section 7 layer 1):
every device path is later validated against these goldens, so the goldens must
be byte-exact vs the real a4/a7 binaries.
"""

import numpy as np
import pytest

from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases

from conftest import run_oracle, OracleCrash


def _is_nonincreasing(data: bytes) -> bool:
    a = np.frombuffer(data, dtype=np.uint8)
    return bool(np.all(a[:-1] >= a[1:]))


def _fuzz_inputs():
    rng = np.random.default_rng(42)
    fixed = [
        b"banana", b"mississippi", b"abab", b"aab", b"abaab", b"cabbage",
        b"aaa", b"baa", b"a", b"ab", b"ba", b"\x00\x00a", b"a\x00b\x00",
        b"abcabcabc", b"yabbadabbado",
    ]
    rand = []
    for i in range(40):
        n = int(rng.integers(1, 200))
        alpha = int(rng.integers(2, 257))
        rand.append(bytes(rng.integers(0, alpha, n, dtype=np.uint8)))
    for i in range(10):
        n = int(rng.integers(200, 3000))
        alpha = int(rng.integers(2, 5))
        rand.append(bytes(rng.integers(97, 97 + alpha, n, dtype=np.uint8)))
    gaunt = [v[:512] for v in gauntlet_cases(512).values()]
    from archon_tpu.utils.corpus import markup_like, text_like

    corpus = [text_like(1500), markup_like(1500), markup_like(400)]
    return fixed + rand + gaunt + corpus


FUZZ = _fuzz_inputs()


@pytest.mark.parametrize("gen", ["a4", "a7"])
def test_encode_matches_reference(oracles, gen):
    if gen not in oracles:
        pytest.skip(f"{gen} oracle unavailable")
    enc = golden.a4_encode if gen == "a4" else golden.a7_encode
    checked = 0
    for data in FUZZ:
        if gen == "a7" and (_is_nonincreasing(data) or len(data) < 3):
            continue  # reference a7 segfaults with zero LMS positions / tiny N
        try:
            ref = run_oracle(oracles[gen], "e", data)
        except OracleCrash:
            continue  # reference bug (e.g. exactly-periodic inputs crash a7)
        got = enc(data)
        if gen == "a7" and got != ref:
            # a7 emits corrupted output on some repetition-rich inputs: its
            # own decoder cannot round-trip them (verified; see module doc of
            # archon_tpu/golden/sa.py).  Our model matches a7's *intended*
            # order (archon.cpp:80-88 sufCompare).  Require instead that the
            # reference fails its own round-trip AND accepts our blob.
            assert run_oracle(oracles[gen], "d", ref) != data, (
                f"a7 diverges on {data[:40]!r} yet reference round-trips"
            )
            assert run_oracle(oracles[gen], "d", got) == data
            continue
        assert got == ref, (
            f"{gen} mismatch on {data[:40]!r}... n={len(data)}\n"
            f" ref={ref.hex()}\n got={got.hex()}"
        )
        checked += 1
    assert checked > 50


@pytest.mark.parametrize("gen", ["a4", "a7"])
def test_decode_roundtrip_and_reference(oracles, gen):
    if gen not in oracles:
        pytest.skip(f"{gen} oracle unavailable")
    enc = golden.a4_encode if gen == "a4" else golden.a7_encode
    dec = golden.a4_decode if gen == "a4" else golden.a7_decode
    for data in FUZZ[:30]:
        if gen == "a7" and (_is_nonincreasing(data) or len(data) < 3):
            continue
        blob = enc(data)
        assert dec(blob) == data
        # the reference decoder must accept our blobs (interop)
        assert run_oracle(oracles[gen], "d", blob) == data
        # our decoder must also decode reference-encoded blobs, whenever the
        # reference itself produced a valid (self-round-trippable) blob
        try:
            ref_blob = run_oracle(oracles[gen], "e", data)
        except OracleCrash:
            continue
        if run_oracle(oracles[gen], "d", ref_blob) == data:
            assert dec(ref_blob) == data
