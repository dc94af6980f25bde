"""Compile + time the cascade-free batched blocks program.

Run standalone (python scripts/compile_blocks_tpu.py [nblocks block_log ...]);
writes the bench blocks marker on success so bench.py's staged auto mode can
include the blocks metric.  Keeps the persistent compile cache warm
(archon_tpu/utils/cache.py).
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    shapes = []
    args = sys.argv[1:]
    while args:
        shapes.append((int(args[0]), int(args[1])))
        args = args[2:]
    if not shapes:
        shapes = [(16, 22)]  # 64 MiB as 16 x 4 MiB — the x1 production shape

    import jax

    from archon_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from archon_tpu.core.batched import bwt_batched_micro
    from archon_tpu.utils.corpus import load_or_synthesize

    for nblocks, blog in shapes:
        bsz = 1 << blog
        size = nblocks * bsz
        name, data = load_or_synthesize(size)
        arr = jnp.asarray(np.frombuffer(data[:size], np.uint8).reshape(nblocks, bsz))

        # direct call of the decorated program — the SAME cache entry serves
        # bench stage 3 and the container io path; completion forced by
        # fetching the tiny per-block resolved vector
        def step(x):
            return bwt_batched_micro(x, "small")

        def force(out):
            return np.asarray(out[-1]).sum()

        print(f"[compile] ({nblocks}, 2^{blog}) = {size >> 20} MiB ...", flush=True)
        t0 = time.time()
        out = step(arr)
        force(out)
        compile_s = time.time() - t0
        print(f"[compile] done in {compile_s:.0f}s; resolved={np.asarray(out[2]).all()}",
              flush=True)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = step(arr)
            force(out)
            times.append(time.perf_counter() - t0)
        # pipelined throughput: K back-to-back dispatches, ONE trailing fetch.
        # This is how the production container actually runs blocks — the
        # per-call host sync amortizes over the pipeline.
        K = 4
        t0 = time.perf_counter()
        for _ in range(K):
            out = step(arr)
        force(out)
        pipe_s = time.perf_counter() - t0
        mbps = max(size / 1e6 / min(times), K * size / 1e6 / pipe_s)
        print(f"[timing] ({nblocks}, 2^{blog}): single {min(times)*1e3:.0f} ms, "
              f"pipelined {pipe_s/K*1e3:.0f} ms/step = {mbps:.1f} MB/s  "
              f"(times: {[round(t, 3) for t in times]})", flush=True)
        marker = os.path.join(_REPO, ".jax_cache", "blocks_warm.marker")
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        prev = {}
        if os.path.exists(marker):
            try:
                with open(marker) as fh:
                    prev = json.load(fh)
            except Exception:
                prev = {}
        import bench as bench_mod

        cur_hash = bench_mod.program_hash()
        # drive the container io layer once: it calls the SAME decorated
        # program (cache hit), so this is cheap and proves `archon e` runs
        # end-to-end warm
        e2e_ok = False
        if os.environ.get("ARCHON_WARM_E2E", "1") == "1":
            from archon_tpu.io.blocks import encode_file

            t0 = time.time()
            try:
                blob = encode_file(data[:size], "a4", block_size=bsz,
                                   verify=False)
                e2e_ok = True
                print(f"[e2e] ({nblocks}, 2^{blog}) container encode "
                      f"{size/1e6/(time.time()-t0):.1f} MB/s incl. "
                      f"{time.time()-t0:.0f}s warm-up", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"[e2e] warm failed: {type(e).__name__}: {e}", flush=True)
        # overwrite unconditionally when the program changed (the old number
        # belongs to a cache entry that no longer exists); otherwise keep the
        # best shape measured for this program
        if prev.get("hash") != cur_hash or mbps > prev.get("mbps", 0.0):
            with open(marker, "w") as fh:
                json.dump({"nblocks": nblocks, "block": bsz,
                           "mbps": round(mbps, 2),
                           "compile_s": round(compile_s, 1),
                           "hash": cur_hash,
                           "files": bench_mod._file_hashes(
                               bench_mod._BLOCKS_SOURCES),
                           "e2e": e2e_ok}, fh)


if __name__ == "__main__":
    main()
