"""Block container + CLI surface tests."""

import subprocess
import sys
from pathlib import Path

import numpy as np

from archon_tpu.io import blocks
from archon_tpu.utils.corpus import text_like


def test_block_container_roundtrip():
    data = text_like(5000)
    for gen in ("a4", "a7"):
        blob = blocks.encode_file(data, gen, block_size=1024)
        assert blocks.decode_file(blob) == data
    # empty file
    assert blocks.decode_file(blocks.encode_file(b"", "a4")) == b""


def test_block_container_fallback_row():
    """A block whose residue exceeds the fast path's micro capacity (8 KiB
    planted repeat in a 256 KiB block) must be flagged unresolved on device
    and re-dispatched through the 1D cascade — the container round-trip
    stays byte-exact either way."""
    n = 1 << 18
    rng = np.random.default_rng(17)
    row = rng.integers(0, 256, n, dtype=np.uint8)
    blk = rng.integers(0, 256, 8192, dtype=np.uint8)
    row[500 : 500 + 8192] = blk
    row[n // 2 : n // 2 + 8192] = blk
    data = row.tobytes() + text_like(1000)
    blob = blocks.encode_file(data, "a4", block_size=n)
    assert blocks.decode_file(blob) == data


def test_block_container_stream_impl():
    """impl='stream' (per-block 1D dispatch stream) must produce the SAME
    container bytes as the batched path, for both generations, incl. a
    pathological block (the 1D cascade handles it with no fallback)."""
    import numpy as np

    rng = np.random.default_rng(5)
    data = (
        text_like(5000)
        + b"ab" * 2000                      # periodic block content
        + bytes(rng.integers(0, 4, 3000, dtype=np.uint8))
    )
    for gen in ("a4", "a7"):
        want = blocks.encode_file(data, gen, block_size=2048)
        got = blocks.encode_file(data, gen, block_size=2048, impl="stream")
        assert got == want
        assert blocks.decode_file(got) == data
    # verify=True detects corruption... and verify=False skips the check
    blob = blocks.encode_file(data, "a4", block_size=2048, impl="stream",
                              verify=False)
    assert blocks.decode_file(blob) == data


def test_block_container_stream_edges():
    # empty file, single tiny block, and a ragged tail through stream
    assert blocks.decode_file(blocks.encode_file(b"", "a4", impl="stream")) == b""
    data = b"x"
    blob = blocks.encode_file(data, "a7", block_size=1024, impl="stream")
    assert blocks.decode_file(blob) == data
    data = text_like(2500)  # 2 full 1 KiB blocks + 452-byte tail
    blob = blocks.encode_file(data, "a4", block_size=1024, impl="stream")
    assert blocks.decode_file(blob) == data
    assert blob == blocks.encode_file(data, "a4", block_size=1024)


def test_block_container_pipelined_units(monkeypatch):
    """The double-buffered dispatch pipeline (ARCHON_PIPE_BLOCKS) must
    produce byte-identical containers for any unit size, incl. a ragged
    tail block and unit-boundary-crossing runs."""
    data = text_like(9 * 1024 + 333)  # 9 full 1 KiB blocks + ragged tail
    blobs = []
    for pipe in ("1", "2", "100"):
        monkeypatch.setenv("ARCHON_PIPE_BLOCKS", pipe)
        blob = blocks.encode_file(data, "a4", block_size=1024)
        assert blocks.decode_file(blob) == data
        blobs.append(blob)
    assert blobs[0] == blobs[1] == blobs[2]


def test_block_extract_reference_compatible(oracles):
    from conftest import run_oracle

    data = text_like(3000)
    blob = blocks.encode_file(data, "a4", block_size=1024)
    if "a4" in oracles:
        block0 = blocks.extract_block(blob, 0)
        assert run_oracle(oracles["a4"], "d", block0) == data[:1024]


def test_cli_roundtrip(tmp_path):
    data = text_like(2000)
    src = tmp_path / "in.bin"
    enc = tmp_path / "out.at"
    dec = tmp_path / "rt.bin"
    src.write_bytes(data)
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(Path(__file__).parent.parent)}
    import os

    env = {**os.environ, **env}
    for cmd in (
        ["e", str(src), str(enc), "-b", "512"],
        ["d", str(enc), str(dec)],
    ):
        r = subprocess.run(
            [sys.executable, "-m", "archon_tpu"] + cmd,
            capture_output=True, env=env, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-500:]
    assert dec.read_bytes() == data


def test_cli_a6_roundtrip(tmp_path):
    import os

    data = b"yabba dabba doo " * 40 + b"end"
    src = tmp_path / "in.bin"
    enc = tmp_path / "out.a6"
    dec = tmp_path / "rt.bin"
    src.write_bytes(data)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(Path(__file__).parent.parent)}
    for cmd in (
        ["a6", str(src), str(enc), "-c", "var"],
        ["a6", str(enc), str(dec), "-c", "var", "-u"],
    ):
        r = subprocess.run(
            [sys.executable, "-m", "archon_tpu"] + cmd,
            capture_output=True, env=env, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-500:]
    assert dec.read_bytes() == data


def test_block_fault_isolation():
    """A corrupt block is isolated and reported; others decode (SURVEY §5
    failure-recovery granularity)."""
    from archon_tpu import native

    data = text_like(4096)
    blob = bytearray(blocks.encode_file(data, "a4", block_size=1024))
    # corrupt block 1's base field: header(12) + block0(4+1024+4) + 4 + 1024
    base_off = 12 + (4 + 1024 + 4) + 4 + 1024
    blob[base_off:base_off + 4] = (10**9).to_bytes(4, "little")
    errors = []
    out = blocks.decode_file(bytes(blob), strict=False,
                             on_error=lambda i, e: errors.append(i))
    assert errors == [1]
    assert out[:1024] == data[:1024]
    assert out[1024:2048] == b"\x00" * 1024
    assert out[2048:] == data[2048:]
    import pytest

    with pytest.raises(ValueError):
        blocks.decode_file(bytes(blob), strict=True)


def test_cli_dp_sp_impl_flags(tmp_path):
    """--dp shards the block batch, --sp routes through the sharded megablock
    pipeline (ATM1 auto-detected on decode), --impl v3 selects the cascade
    program — all on the suite's 8-device CPU mesh (config knobs must be
    consumed, not decorative)."""
    from archon_tpu.cli import main

    data = text_like(40000, seed=11)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    for extra in (["--dp", "4", "--impl", "v3", "-b", "8192"],
                  ["--sp", "8"]):
        enc = tmp_path / "out.arc"
        dec = tmp_path / "out.bin"
        assert main(["e", str(src), str(enc)] + extra) == 0
        assert main(["d", str(enc), str(dec)]) == 0
        assert dec.read_bytes() == data, extra


def test_cli_resume_flag_consumed(tmp_path, capsys):
    """--resume must actually route through encode_to_path (not merely
    be parsed): a second resume run recomputes ZERO
    blocks, and a truncated container is repaired to byte-identical."""
    from archon_tpu.cli import main

    data = text_like(6000)
    src = tmp_path / "in.bin"
    out = tmp_path / "out.at1"
    src.write_bytes(data)
    assert main(["e", str(src), str(out), "-b", "1024", "--resume"]) == 0
    full = out.read_bytes()
    assert "6 block(s) recomputed" in capsys.readouterr().out
    assert blocks.decode_file(full) == data
    # second resume run: nothing to do
    assert main(["e", str(src), str(out), "-b", "1024", "--resume"]) == 0
    assert "0 block(s) recomputed" in capsys.readouterr().out
    assert out.read_bytes() == full
    # truncate mid-frame; resume repairs only the tail
    out.write_bytes(full[: len(full) - 700])
    assert main(["e", str(src), str(out), "-b", "1024", "--resume"]) == 0
    assert out.read_bytes() == full


def test_corpus_env_override(tmp_path, monkeypatch):
    """$ARCHON_CORPUS points the bench corpus loader at a real file; absent
    that, it logs the acquisition attempt and synthesizes (corpus
    honesty)."""
    import importlib

    from archon_tpu.utils import corpus

    real = tmp_path / "enwik8"
    real.write_bytes(b"x" * 1000)
    monkeypatch.setenv("ARCHON_CORPUS", str(real))
    name, data = corpus.load_or_synthesize(500)
    assert name == "enwik8" and data == b"x" * 500
    monkeypatch.delenv("ARCHON_CORPUS")
    name, data = corpus.load_or_synthesize(500)
    assert name == "synthetic-text" and len(data) == 500


def test_resume_input_drift_guard(tmp_path):
    """--resume must not trust stale frames: if the INPUT
    changed since the partial encode, kept frames would silently decode to
    the OLD bytes.  The guard round-trips the last kept frame against the
    current input and restarts on mismatch; a SHRUNK input additionally
    truncates frames beyond the new block count."""
    old = text_like(6000, seed=1)
    new = text_like(6000, seed=2)
    out = tmp_path / "o.at1"
    blocks.encode_to_path(old, out, block_size=1024)
    # drop the final frame to force a resume with kept frames
    sz = out.stat().st_size
    out.write_bytes(out.read_bytes()[: sz - 700])
    n = blocks.encode_to_path(new, out, block_size=1024, resume=True)
    assert n == 6  # drift detected -> full recompute, not a 1-block patch
    assert blocks.decode_file(out.read_bytes()) == new

    # shrink: a shorter input must not leave stale frames past its end
    short = old[: 3 * 1024 + 100]
    blocks.encode_to_path(old, out, block_size=1024)
    blocks.encode_to_path(short, out, block_size=1024, resume=True)
    assert blocks.decode_file(out.read_bytes()) == short

    # unchanged input still resumes with zero recompute
    blocks.encode_to_path(old, out, block_size=1024)
    assert blocks.encode_to_path(old, out, block_size=1024, resume=True) == 0


def test_streamed_window_bounds_inflight(monkeypatch):
    """The streamed dispatcher must keep at most ARCHON_PIPE_BLOCKS blocks
    in flight: device-resident footprint O(window),
    not O(file).  Tracked by shimming bwt_v3 with lazily-fetched results."""
    from archon_tpu.core import fast2
    from archon_tpu.io.blocks import _streamed_forward

    state = {"live": 0, "max": 0}

    class LazyL:
        def __init__(self, arr):
            self.arr = arr
            self.fetched = False

        def __array__(self, dtype=None, copy=None):
            if not self.fetched:
                self.fetched = True
                state["live"] -= 1
            return self.arr

    real = fast2.bwt_v3

    def shim(arr, sentinel):
        state["live"] += 1
        state["max"] = max(state["max"], state["live"])
        L, base = real(arr, sentinel)
        return LazyL(np.asarray(L)), int(base)

    monkeypatch.setattr(fast2, "bwt_v3", shim)
    monkeypatch.setenv("ARCHON_PIPE_BLOCKS", "3")
    data = text_like(24 * 256, seed=5)
    blks = [data[i : i + 256] for i in range(0, len(data), 256)]
    out = _streamed_forward(blks, "a4", verify=False)
    assert state["max"] <= 4  # window 3 + the one being dispatched
    # results are still correct and complete
    from archon_tpu.golden.sa import bwt_inverse

    got = b"".join(
        bwt_inverse(np.asarray(L), int(b), "small").tobytes() for L, b in out
    )
    assert got == data
