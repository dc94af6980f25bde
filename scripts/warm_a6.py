"""Compile + time the a6 device programs and write the bench a6 marker
(puts a6 on the device scoreboard).

Since round 4 the var (Huffman) config reduces exactly to the n-symbol
program (core/a6._symbol_rank_map: prefix-free codes resolve bit-suffix
comparisons at symbol granularity), so ONE compiled program serves byte and
var — this script warms it at the byte size and times both configs.

Usage: python scripts/warm_a6.py [byte_log]   (default 24 = 16 MiB)
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    blog = int(sys.argv[1]) if len(sys.argv) > 1 else 24

    import jax

    from archon_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    import bench as bench_mod
    from archon_tpu.core.a6 import (
        _a6_symbol_transform,
        _symbol_rank_map,
        build_codes,
    )
    from archon_tpu.utils.corpus import load_or_synthesize

    bsize = 1 << blog
    _, data = load_or_synthesize(bsize)
    npdata = np.frombuffer(data[:bsize], np.uint8)
    arr = jnp.asarray(npdata)

    def timed(label, code_map):
        t0 = time.time()
        out = _a6_symbol_transform(arr, code_map)
        float(out[-1])
        compile_s = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = _a6_symbol_transform(arr, code_map)
            float(out[-1])
            times.append(time.perf_counter() - t0)
        mbps = bsize / 1e6 / min(times)
        print(
            f"[warm_a6] {label} {bsize >> 20}MiB: compile {compile_s:.0f}s, "
            f"best {min(times)*1e3:.0f} ms = {mbps:.1f} MB/s", flush=True,
        )
        return mbps, compile_s

    byte_map = jnp.asarray(np.arange(256, dtype=np.uint8))
    byte_mbps, c1 = timed("byte", byte_map)
    var_map = jnp.asarray(_symbol_rank_map(build_codes(npdata, "var")))
    var_mbps, c2 = timed("var", var_map)

    # a6 at the 4 MiB stream-block shape (the production container's block
    # size): pipelined dispatches, the same methodology as the stream
    # headline — a6 throughput when processing a stream of 4 MiB blocks
    s22 = 1 << 22
    arr22 = jnp.asarray(npdata[:s22])
    t0 = time.time()
    out = _a6_symbol_transform(arr22, var_map)
    float(out[-1])
    c22 = time.time() - t0
    t0 = time.perf_counter()
    for _ in range(4):
        out = _a6_symbol_transform(arr22, var_map)
    float(out[-1])
    piped = (time.perf_counter() - t0) / 4
    stream_mbps = s22 / 1e6 / piped
    print(
        f"[warm_a6] var 4MiB pipelined: compile {c22:.0f}s, "
        f"{piped*1e3:.0f} ms = {stream_mbps:.1f} MB/s", flush=True,
    )

    # a6 var INVERSE: code-ordered bucket starts + native walk
    from archon_tpu.core.a6 import a6_decode, a6_forward

    out, base = a6_forward(npdata, "var")
    blob = np.uint32(base).tobytes() + out.tobytes()
    t0 = time.time()
    a6_decode(blob, "var")
    c3 = time.time() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        a6_decode(blob, "var")
        times.append(time.perf_counter() - t0)
    inv_mbps = bsize / 1e6 / min(times)
    print(
        f"[warm_a6] var inverse {bsize >> 20}MiB: compile {c3:.0f}s, "
        f"best {min(times)*1e3:.0f} ms = {inv_mbps:.1f} MB/s", flush=True,
    )

    # the all_coded fallback: a single-distinct-symbol
    # input gets a zero-length Huffman code and takes the literal bit-domain
    # program — bench one case so the cliff has a number
    fb_size = 1 << 20
    fb_data = np.full(fb_size, 65, np.uint8)
    t0 = time.time()
    a6_forward(fb_data, "var")
    c4 = time.time() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        a6_forward(fb_data, "var")
        times.append(time.perf_counter() - t0)
    fb_mbps = fb_size / 1e6 / min(times)
    print(
        f"[warm_a6] var all_coded-fallback {fb_size >> 20}MiB: compile "
        f"{c4:.0f}s, best {min(times)*1e3:.0f} ms = {fb_mbps:.1f} MB/s",
        flush=True,
    )

    marker = os.path.join(_REPO, ".jax_cache", "a6_warm.marker")
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    with open(marker, "w") as fh:
        json.dump(
            {
                "hash": bench_mod.program_hash(bench_mod._A6_SOURCES),
                "files": bench_mod._file_hashes(bench_mod._A6_SOURCES),
                "byte_size": bsize,
                "var_size": bsize,
                "byte_mbps": round(byte_mbps, 2),
                "var_mbps": round(var_mbps, 2),
                "var_inverse_mbps": round(inv_mbps, 2),
                "var_stream4_mbps": round(stream_mbps, 2),
                "fallback_size": fb_size,
                "var_fallback_mbps": round(fb_mbps, 2),
                "compile_s": round(c1 + c2 + c3 + c4, 1),
            },
            fh,
        )
    print(f"[warm_a6] marker written: {marker}", flush=True)


if __name__ == "__main__":
    main()
