"""Compile + time the streamed per-block 1D program and write the bench
stream marker (the io/blocks impl='stream' container path).

Warms core/fast2.bwt_v3 raw (L, base) at the block size for BOTH sentinel
conventions, measures the streamed aggregate throughput (dispatch all
blocks, one trailing base fetch), and records the marker bench.py's stream
stage is gated on.

Usage: python scripts/warm_stream.py [nblocks block_log]   (default 16 22)
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    small_only = "--small-only" in sys.argv[1:]
    nb = int(args[0]) if args else 16
    blog = int(args[1]) if len(args) > 1 else 22

    import jax

    from archon_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    import bench as bench_mod
    from archon_tpu.core.fast2 import bwt_v3
    from archon_tpu.utils.corpus import load_or_synthesize

    bsz = 1 << blog
    size = nb * bsz
    _, data = load_or_synthesize(size)
    blks = [
        jnp.asarray(np.frombuffer(data[i * bsz : (i + 1) * bsz], np.uint8))
        for i in range(nb)
    ]

    t0 = time.time()
    L, base = bwt_v3(blks[0], "small")
    int(base)
    print(f"[warm_stream] small compile {time.time()-t0:.0f}s", flush=True)
    if not small_only:
        t0 = time.time()
        L, base = bwt_v3(blks[0], "large")
        int(base)
        print(f"[warm_stream] large compile {time.time()-t0:.0f}s", flush=True)

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [bwt_v3(b, "small") for b in blks]
        int(outs[-1][1])  # in-order queue: last base = stream barrier
        times.append(time.perf_counter() - t0)
    mbps = size / 1e6 / min(times)
    blabel = f"{bsz >> 20}MiB" if bsz >= (1 << 20) else f"{bsz >> 10}KiB"
    print(
        f"[warm_stream] streamed {nb}x{blabel}: {min(times)*1e3:.0f} ms "
        f"= {mbps:.1f} MB/s", flush=True,
    )

    marker = os.path.join(_REPO, ".jax_cache", "stream_warm.marker")
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    # "blocks_warm": every block size compiled under the
    # current program hash — bench's container-e2e stage picks the format
    # default (4 MiB) from this list even when the headline marker shape is
    # a smaller throughput-sweep block.
    warm_list = {bsz}
    prev = None
    try:
        with open(marker) as fh:
            prev = json.load(fh)
        if prev.get("hash") == bench_mod.program_hash():
            warm_list.update(int(b) for b in prev.get("blocks_warm", [prev.get("block", bsz)]))
    except Exception:
        prev = None
    # best-shape-wins: a sweep probe must not demote the marker to a slower
    # shape — keep an existing same-hash marker whose measured mbps is
    # higher (but still record this shape as warmed)
    if (
        prev is not None
        and prev.get("hash") == bench_mod.program_hash()
        and float(prev.get("mbps", 0.0)) > mbps
        and (prev.get("nblocks"), prev.get("block")) != (nb, bsz)
    ):
        prev["blocks_warm"] = sorted(warm_list)
        with open(marker, "w") as fh:
            json.dump(prev, fh)
        print(
            f"[warm_stream] keeping existing marker "
            f"{prev['nblocks']}x{prev['block']} at {prev['mbps']} MB/s "
            f"(> {mbps:.1f}); blocks_warm={sorted(warm_list)}", flush=True,
        )
        return
    with open(marker, "w") as fh:
        json.dump(
            {
                "nblocks": nb,
                "block": bsz,
                "mbps": round(mbps, 2),
                "hash": bench_mod.program_hash(),
                "files": bench_mod._file_hashes(bench_mod._BLOCKS_SOURCES),
                "blocks_warm": sorted(warm_list),
            },
            fh,
        )
    print(f"[warm_stream] marker written: {marker}", flush=True)


if __name__ == "__main__":
    main()
