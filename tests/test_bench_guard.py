"""bench.py warm-marker guard: per-file drift reporting."""

import sys
from pathlib import Path


def _bench():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench

    return bench


def test_program_hash_per_source_files():
    bench = _bench()
    files = bench._file_hashes(bench._BLOCKS_SOURCES)
    assert set(files) == set(bench._BLOCKS_SOURCES)
    assert bench.program_hash() == bench._combined(files)
    # a6 hash covers a superset of the blocks sources
    a6_files = bench._file_hashes(bench._A6_SOURCES)
    assert set(files) < set(a6_files)


def test_warn_stale_names_changed_files(capsys):
    bench = _bench()
    files = bench._file_hashes(bench._BLOCKS_SOURCES)
    stale = dict(files)
    stale["archon_tpu/core/fast2.py"] = "0" * 16
    bench.warn_stale(
        {"files": stale}, bench._BLOCKS_SOURCES, "blocks",
        "scripts/compile_blocks_tpu.py",
    )
    err = capsys.readouterr().err
    assert "STALE COMPILE CACHE" in err
    assert "archon_tpu/core/fast2.py" in err
    assert "archon_tpu/core/batched.py" not in err  # unchanged: not named
    assert "compile_blocks_tpu.py" in err


def test_warn_stale_without_file_map(capsys):
    bench = _bench()
    bench.warn_stale({}, bench._BLOCKS_SOURCES, "blocks", "x.py")
    err = capsys.readouterr().err
    assert "STALE COMPILE CACHE" in err


def test_it2_marker_hash_includes_it2_source():
    bench = _bench()
    srcs = bench._BLOCKS_SOURCES + ("archon_tpu/core/it2.py",)
    files = bench._file_hashes(srcs)
    assert "archon_tpu/core/it2.py" in files
    # editing it2.py must invalidate the it2 stage but NOT the stream stage
    assert bench.program_hash(srcs) != bench.program_hash()


def test_warm_stream_marker_best_shape_and_blocks_warm(tmp_path):
    """warm_stream keeps the best-mbps marker and accumulates the
    blocks_warm list bench's e2e stage picks the 4 MiB default from."""
    import json

    bench = _bench()
    marker = tmp_path / "stream_warm.marker"
    cur = {
        "nblocks": 512, "block": 1 << 17, "mbps": 172.4,
        "hash": bench.program_hash(),
        "files": bench._file_hashes(bench._BLOCKS_SOURCES),
        "blocks_warm": [1 << 17, 1 << 22],
    }
    marker.write_text(json.dumps(cur))
    # the e2e selection rule (mirrors bench.py): format default preferred
    from archon_tpu.io.blocks import DEFAULT_BLOCK

    wl = json.loads(marker.read_text()).get("blocks_warm", [])
    assert DEFAULT_BLOCK in wl
    size_cap = 1 << 26
    e2e_shape = (max(1, min(size_cap, 1 << 26) // DEFAULT_BLOCK), DEFAULT_BLOCK)
    assert e2e_shape == (16, DEFAULT_BLOCK)
