"""Batched (block-parallel) suffix sort / BWT vs golden model."""

import numpy as np
import pytest

from archon_tpu.core.batched import (
    bwt_forward_batched,
    suffix_arrays_batched,
)
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases, text_like


def _block_matrix(n: int, seed: int = 5):
    """Rows exercising different regimes in one batch: random, text-like,
    constant run, periodic (Gauntlet-family), sparse alphabet."""
    rng = np.random.default_rng(seed)
    rows = [
        rng.integers(0, 256, n, dtype=np.uint8),
        np.frombuffer(text_like(n, seed + 1), np.uint8),
        np.zeros(n, np.uint8),
        np.frombuffer((b"ab" * n)[:n], np.uint8),
        rng.integers(0, 3, n, dtype=np.uint8),
    ]
    g = list(gauntlet_cases(n).values())
    for blob in g[:3]:
        row = np.frombuffer((blob * (n // len(blob) + 1))[:n], np.uint8)
        rows.append(row)
    return np.stack(rows)


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("n", [64, 333, 1024])
def test_batched_sa_matches_golden(sentinel, n):
    mat = _block_matrix(n)
    got = suffix_arrays_batched(mat, sentinel)
    for b in range(mat.shape[0]):
        want = golden.suffix_array(mat[b], sentinel)
        assert got[b].tolist() == want.tolist(), f"row {b} n={n} {sentinel}"


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_batched_bwt_matches_golden(sentinel):
    n = 500
    mat = _block_matrix(n, seed=11)
    L2, base2, rank2 = bwt_forward_batched(mat, sentinel)
    L2, base2 = np.asarray(L2), np.asarray(base2)
    for b in range(mat.shape[0]):
        want_L, want_base = golden.bwt_forward(mat[b], sentinel)
        assert L2[b].tolist() == want_L.tolist(), f"row {b}"
        assert int(base2[b]) == int(want_base), f"row {b}"
        # round-trip through the golden inverse (which emits the reverse
        # of the pre-BWT string, matching the reference decoders)
        back = golden.bwt_inverse(L2[b], int(base2[b]), sentinel)
        assert back.tolist() == mat[b][::-1].tolist()


def test_batched_single_row_matches_fast():
    from archon_tpu.core.fast import suffix_array_fast

    data = np.frombuffer(text_like(2048, 3), np.uint8)
    got = suffix_arrays_batched(data[None, :], "small")[0]
    want = suffix_array_fast(data, "small")
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("n", [128, 700])
def test_batched_v3_matches_golden(sentinel, n):
    from archon_tpu.core.batched import bwt_batched_v3

    mat = _block_matrix(n, seed=13)
    L2, base2 = bwt_batched_v3(mat, sentinel)
    L2, base2 = np.asarray(L2), np.asarray(base2)
    for b in range(mat.shape[0]):
        want_L, want_base = golden.bwt_forward(mat[b], sentinel)
        assert L2[b].tolist() == want_L.tolist(), f"row {b} n={n}"
        assert int(base2[b]) == int(want_base), f"row {b} n={n}"


def test_batched_v3_text_blocks():
    from archon_tpu.core.batched import bwt_batched_v3

    rows = np.stack([np.frombuffer(text_like(2048, s), np.uint8) for s in range(6)])
    L2, base2 = bwt_batched_v3(rows, "small")
    L2, base2 = np.asarray(L2), np.asarray(base2)
    for b in range(rows.shape[0]):
        want_L, want_base = golden.bwt_forward(rows[b], "small")
        assert L2[b].tolist() == want_L.tolist()
        assert int(base2[b]) == int(want_base)

def _planted_repeat_row(n, rep_len, alpha, seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, alpha, n, dtype=np.uint8)
    blk = rng.integers(0, alpha, rep_len, dtype=np.uint8)
    row[500 : 500 + rep_len] = blk
    row[n // 2 : n // 2 + rep_len] = blk
    return row


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_batched_v3_mixed_tail_paths(sentinel):
    """One batch whose rows diverge across emission branches (fully
    resolved / micro-tail residue / residue deeper than the micro tail's
    16k context coverage) — exercises the per-row micro refinement and the
    global cascade fallback together (see test_fast2 for the 1D probes)."""
    from archon_tpu.core.batched import bwt_batched_v3

    n = 32768
    rng = np.random.default_rng(21)
    rows = np.stack(
        [
            rng.integers(0, 256, n, dtype=np.uint8),    # resolves directly
            _planted_repeat_row(n, 100, 256, 22),       # micro residue
            _planted_repeat_row(n, 500, 2, 23),         # micro after 1 round
            _planted_repeat_row(n, 1000, 2, 24),        # beyond micro -> cascade
        ]
    )
    L2, base2 = bwt_batched_v3(rows, sentinel)
    L2, base2 = np.asarray(L2), np.asarray(base2)
    for b in range(rows.shape[0]):
        want_L, want_base = golden.bwt_forward(rows[b], sentinel)
        assert L2[b].tolist() == want_L.tolist(), f"row {b}"
        assert int(base2[b]) == int(want_base), f"row {b}"


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_batched_micro_fast_path(sentinel):
    """The cascade-free production program: rows it reports resolved must be
    byte-exact; rows beyond the micro tail must be flagged unresolved (the
    container re-dispatches those through the 1D cascade)."""
    from archon_tpu.core.batched import (
        bwt_batched_micro,
        bwt_batched_micro_certified,
    )

    n = 32768
    rng = np.random.default_rng(41)
    rows = np.stack(
        [
            rng.integers(0, 256, n, dtype=np.uint8),   # resolves in the loop
            _planted_repeat_row(n, 100, 256, 42),      # micro residue
            _planted_repeat_row(n, 1000, 2, 43),       # deep ties
            np.zeros(n, np.uint8),                     # degenerate run
        ]
    )
    # at this n the lockstep loop runs until k >= n, so every row resolves
    L2, base2, resolved = bwt_batched_micro(rows, sentinel)
    L2, base2, resolved = np.asarray(L2), np.asarray(base2), np.asarray(resolved)
    assert resolved.all()
    for b in range(rows.shape[0]):
        want_L, want_base = golden.bwt_forward(rows[b], sentinel)
        assert L2[b].tolist() == want_L.tolist(), f"row {b}"
        assert int(base2[b]) == int(want_base), f"row {b}"

    Lc, basec, ok, res_c = bwt_batched_micro_certified(rows, sentinel)
    Lc, basec = np.asarray(Lc), np.asarray(basec)
    ok, res_c = np.asarray(ok), np.asarray(res_c)
    assert res_c.tolist() == resolved.tolist()
    assert ok.all()
    assert Lc.tolist() == L2.tolist()
    assert basec.tolist() == base2.tolist()


def test_batched_micro_unresolved_flag():
    """A residue that exceeds the micro tail's 4096-active capacity at loop
    exit (an ~8 KiB planted repeat in a 256 KiB block makes the loop exit
    with ~10k actives) must be flagged unresolved, and resolved rows in the
    same batch must still be exact (vs the golden-tested 1D path — golden
    itself is too slow at this n)."""
    from archon_tpu.core.batched import bwt_batched_micro
    from archon_tpu.core.fast2 import bwt_v3

    n = 1 << 18
    rng = np.random.default_rng(7)
    rows = np.stack(
        [
            rng.integers(0, 256, n, dtype=np.uint8),
            _planted_repeat_row(n, 8192, 256, 9),
        ]
    )
    L2, base2, resolved = bwt_batched_micro(rows, "small")
    resolved = np.asarray(resolved)
    assert resolved[0] and not resolved[1]
    want_L, want_base = bwt_v3(rows[0], "small")
    assert np.asarray(L2)[0].tolist() == np.asarray(want_L).tolist()
    assert int(np.asarray(base2)[0]) == int(want_base)


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_batched_v3_micro_only_batch(sentinel):
    """All rows resolve in the micro tail (no cascade): the emission must
    come entirely from the tile extraction + snapshot refinement path."""
    from archon_tpu.core.batched import bwt_batched_v3

    n = 32768
    rows = np.stack(
        [
            _planted_repeat_row(n, 100, 256, 31),
            _planted_repeat_row(n, 120, 256, 32),
        ]
    )
    L2, base2 = bwt_batched_v3(rows, sentinel)
    L2, base2 = np.asarray(L2), np.asarray(base2)
    for b in range(rows.shape[0]):
        want_L, want_base = golden.bwt_forward(rows[b], sentinel)
        assert L2[b].tolist() == want_L.tolist(), f"row {b}"
        assert int(base2[b]) == int(want_base), f"row {b}"


def test_gauntlet_megascale_container_roundtrip():
    """Gauntlet-class pathologies at published scale (1 MiB, not toy
    4 KiB): the production container must transform and invert
    the worst repetition structures exactly, through whatever mix of fast
    path and cascade fallback they trigger."""
    from archon_tpu.io import blocks as ioblocks
    from archon_tpu.utils.corpus import gauntlet_cases

    cases = gauntlet_cases(1 << 20)
    for name in ("fibonacci", "period2", "nested"):
        data = cases[name]
        blob = ioblocks.encode_file(data, "a4", block_size=1 << 18)
        assert ioblocks.decode_file(blob) == data, name
