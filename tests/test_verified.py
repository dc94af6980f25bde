"""Always-on verification (certified production path) + checkpoint/resume.

The reference keeps verification compiled into its production binaries
(a4/src/main.c:7 VERIFY; a6/src/bwt.c:19-23 VERIFY=VF_SORT checks during
output) — these tests pin our equivalents: the fused per-block LF
certificate on the v3 pipeline, its rejection of corrupted outputs, and the
block-granular resume the per-block framing enables (final/x1/ArchonX1.c:
53-60 is the framing; the reference itself has no resume)."""

import numpy as np
import pytest

from archon_tpu.core.batched import (
    bwt_batched_v3,
    bwt_batched_v3_certified,
    verify_bwt_batched,
)
from archon_tpu.golden import sa as golden
from archon_tpu.io import blocks
from archon_tpu.utils.corpus import gauntlet_cases, text_like


def _block_matrix(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    rows = [
        rng.integers(0, 256, n, dtype=np.uint8),
        np.frombuffer(text_like(n, seed + 1), np.uint8),
        np.zeros(n, np.uint8),
        np.frombuffer((b"ab" * n)[:n], np.uint8),
    ]
    for blob in list(gauntlet_cases(n).values())[:2]:
        rows.append(np.frombuffer((blob * (n // len(blob) + 1))[:n], np.uint8))
    return np.stack(rows)


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("n", [64, 777, 2048])
def test_certified_matches_golden_and_passes(sentinel, n):
    mat = _block_matrix(n)
    L2, base2, ok2 = bwt_batched_v3_certified(mat, sentinel)
    L2, base2, ok2 = np.asarray(L2), np.asarray(base2), np.asarray(ok2)
    assert ok2.all(), f"certificate rejected a correct BWT ({sentinel}, n={n})"
    Lu, bu = bwt_batched_v3(mat, sentinel)
    assert np.array_equal(L2, np.asarray(Lu)) and np.array_equal(
        base2, np.asarray(bu)
    ), "certified and uncertified paths disagree"
    for b in range(mat.shape[0]):
        want_L, want_base = golden.bwt_forward(mat[b], sentinel)
        assert L2[b].tolist() == want_L.tolist(), f"row {b}"
        assert int(base2[b]) == int(want_base), f"row {b}"


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_certificate_rejects_corruption(sentinel):
    """verify_bwt_batched must reject: wrong L byte, wrong base, non-
    permutation rank, permutation-but-wrong-order rank."""
    n = 512
    mat = _block_matrix(n, seed=9)
    B = mat.shape[0]
    def rank_array(row):
        sa = golden.suffix_array(row, sentinel)
        r = np.empty(n, np.int32)
        r[sa] = np.arange(n, dtype=np.int32)
        return r

    rank2 = np.stack([rank_array(mat[b]) for b in range(B)])
    L2 = np.stack([golden.bwt_forward(mat[b], sentinel)[0] for b in range(B)])
    base2 = np.asarray(
        [golden.bwt_forward(mat[b], sentinel)[1] for b in range(B)], np.int32
    )
    ok = np.asarray(verify_bwt_batched(mat, rank2, L2, base2, sentinel))
    assert ok.all()

    bad_L = L2.copy()
    bad_L[0, 17] ^= 0xFF
    ok = np.asarray(verify_bwt_batched(mat, rank2, bad_L, base2, sentinel))
    assert not ok[0] and ok[1:].all()

    bad_base = base2.copy()
    bad_base[1] = (bad_base[1] + 1) % n
    ok = np.asarray(verify_bwt_batched(mat, rank2, L2, bad_base, sentinel))
    assert not ok[1] and ok[0] and ok[2:].all()

    bad_rank = rank2.copy()
    bad_rank[2, 5] = bad_rank[2, 6]  # not a permutation
    ok = np.asarray(verify_bwt_batched(mat, bad_rank, L2, base2, sentinel))
    assert not ok[2]

    swp = rank2.copy()  # permutation, wrong suffix order
    swp[0, [3, 4]] = swp[0, [4, 3]]
    ok = np.asarray(verify_bwt_batched(mat, swp, L2, base2, sentinel))
    assert not ok[0]


def test_encode_file_verify_wired():
    """encode_file(verify=True) runs the certificate; roundtrips intact."""
    data = text_like(6000)
    blob = blocks.encode_file(data, "a4", block_size=2048, verify=True)
    assert blocks.decode_file(blob) == data


def test_resume_after_truncation(tmp_path):
    """Checkpoint/resume at block granularity: truncate an encode mid-frame,
    resume, and get a byte-identical container while recomputing only the
    missing blocks."""
    data = text_like(10 * 1024, seed=3)
    full = tmp_path / "full.at"
    part = tmp_path / "part.at"
    n_full = blocks.encode_to_path(bytes(data), full, "a4", block_size=1024)
    assert n_full == 10
    want = full.read_bytes()

    # simulate a crash: keep the header + 4 complete frames + half a frame
    frame = 4 + 1024 + 4
    cut = 12 + 4 * frame + frame // 3
    part.write_bytes(want[:cut])
    redone = blocks.encode_to_path(
        bytes(data), part, "a4", block_size=1024, resume=True
    )
    assert redone == 6, "resume must recompute only the missing blocks"
    assert part.read_bytes() == want

    # resume over a complete container is a no-op
    assert (
        blocks.encode_to_path(bytes(data), part, "a4", block_size=1024, resume=True)
        == 0
    )
    assert part.read_bytes() == want

    # resume with a mismatched header re-encodes from scratch
    redone = blocks.encode_to_path(
        bytes(data), part, "a4", block_size=2048, resume=True
    )
    assert redone == 5
    assert blocks.decode_file(part.read_bytes()) == data


def test_checked_wrapper_surfaces_oob():
    """utils/debug.checked: the checkify wrapper flags out-of-bounds gathers
    that silent clamping would otherwise hide (the debug-build analog of the
    reference's assert density)."""
    import jax.numpy as jnp

    from archon_tpu.utils.debug import checked

    def gather(idx):
        return jnp.arange(8)[idx].sum()

    err, out = checked(gather)(jnp.array([1, 2, 3]))
    err.throw()  # in-bounds: no error
    err, out = checked(gather)(jnp.array([1, 2, 99]))
    with pytest.raises(Exception):
        err.throw()


def test_poison_check_on_narrowed_path():
    """a5 DM_CHECK analog (utils/debug.poison_check): the final rank array
    of the narrowed pipeline must contain no surviving -1 pads."""
    from archon_tpu.core.fast2 import suffix_ranks_v2
    from archon_tpu.utils.debug import poison_check

    data = np.frombuffer(text_like(3000, seed=7), np.uint8)
    rank = np.asarray(suffix_ranks_v2(data, "small"))
    poison_check(rank, poison=-1, name="suffix_ranks_v2")
    # and it does trip on a poisoned array
    bad = rank.copy()
    bad[5] = -1
    with pytest.raises(AssertionError):
        poison_check(bad, poison=-1, name="bad")
