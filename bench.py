"""Benchmark: forward BWT throughput per device (+ decode as a bonus field).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N, ...}

vs_baseline is measured against the 500 MB/s/chip north-star target from
BASELINE.md (the reference publishes no absolute numbers).

Structure:

1. **Hard deadline.**  A watchdog thread prints the best result measured so
   far and exits the process at BENCH_BUDGET seconds (default 450), so a
   partial number is printed even when a compile outlasts the budget.
2. **Staged escalation.**  Stage 1 measures the whole-file v3 sorter at a
   modest size so a number exists early; stage 2 re-measures at full size;
   the streamed, batched-blocks, a6 and it2 stages run only when a marker
   file under .jax_cache/ (written by the scripts/ warm runs) matches the
   current sources.
3. **Persistent compilation cache** (archon_tpu/utils/cache.py):
   $JAX_COMPILATION_CACHE_DIR when set, else the repo's .jax_cache/.

BENCH_IMPL forces a single-stage run: v3|v2|fast|plain|a6|blocks.
BENCH_SIZE caps the stage-2 size (default 64 MiB); BENCH_BLOCK the block
size for blocks mode (default x1's 4 MiB, ArchonX1.c:19).
"""

import json
import os
import sys
import threading
import time

import numpy as np

BASELINE_MBPS = 500.0
_REPO = os.path.dirname(os.path.abspath(__file__))
_BLOCKS_MARKER = os.path.join(_REPO, ".jax_cache", "blocks_warm.marker")
_A6_MARKER = os.path.join(_REPO, ".jax_cache", "a6_warm.marker")
_STREAM_MARKER = os.path.join(_REPO, ".jax_cache", "stream_warm.marker")
_IT2_MARKER = os.path.join(_REPO, ".jax_cache", "it2_warm.marker")


_BLOCKS_SOURCES = (
    "archon_tpu/core/batched.py",
    "archon_tpu/core/fast2.py",
    "archon_tpu/core/doubling.py",
    "archon_tpu/ops/scan.py",
)
_A6_SOURCES = _BLOCKS_SOURCES + (
    "archon_tpu/core/a6.py",
    "archon_tpu/ops/bitpack.py",
    "archon_tpu/entropy/huffman.py",
)


def _file_hashes(sources) -> dict:
    import hashlib

    out = {}
    for rel in sources:
        p = os.path.join(_REPO, rel)
        if os.path.exists(p):
            with open(p, "rb") as fh:
                out[rel] = hashlib.sha256(fh.read()).hexdigest()[:16]
    return out


def _combined(hashes: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for rel in sorted(hashes):
        h.update(hashes[rel].encode())
    return h.hexdigest()[:16]


def program_hash(sources=_BLOCKS_SOURCES) -> str:
    """Hash of the sources defining a warmed device program.  The marker
    stores this (plus per-file hashes) at compile time; a mismatch at bench
    time means the cache entry no longer matches the code and the stage
    would start with a cold compile — skip it rather than let the compile
    eat the bench budget."""
    return _combined(_file_hashes(sources))


def warn_stale(marker: dict, sources, stage: str, script: str) -> None:
    """LOUD drift report: name exactly which warmed source files changed so
    the fix (one re-warm run) is obvious — a silent skip hides which
    metrics went missing."""
    cur = _file_hashes(sources)
    old = marker.get("files", {})
    changed = sorted(
        set(k for k in cur if cur.get(k) != old.get(k))
        | (set(old) - set(cur))
    ) or ["(per-file hashes missing from marker; any of the sources)"]
    sep = "!" * 72
    print(
        f"{sep}\n[bench] STALE COMPILE CACHE for stage '{stage}': the warmed "
        f"program no longer matches the source.  Changed files:\n"
        + "".join(f"[bench]     {c}\n" for c in changed)
        + f"[bench] The {stage} metric is SKIPPED this run.  Re-warm with:\n"
        f"[bench]     python {script}\n"
        f"[bench] (the persistent compilation cache then makes the next "
        f"bench run execute-only)\n{sep}",
        file=sys.stderr,
        flush=True,
    )

# state shared with the watchdog: "results" maps priority -> latest complete
# result dict at that priority; "printed" flips once a line has been emitted.
# The HEADLINE is the highest-priority metric measured (production blocks
# program > full-size whole-file > small whole-file) — NOT the best value:
# a best-value rule would make a small-size number the headline and
# flatter the result.  Lower-priority numbers ride along as fields.
_STATE = {"results": {}, "extra": {}, "printed": False}
_LOCK = threading.Lock()
_STREAM_RESULTS: list = []  # (L, base) per streamed block, for decode timing


def _record(result: dict, priority: int = 0) -> None:
    print(f"[bench] {json.dumps(result)}", file=sys.stderr, flush=True)
    with _LOCK:
        _STATE["results"][priority] = result


def _record_extra(key: str, value) -> None:
    print(f"[bench] {json.dumps({key: value})}", file=sys.stderr, flush=True)
    with _LOCK:
        _STATE["extra"][key] = value


def _emit() -> None:
    with _LOCK:
        if _STATE["printed"]:
            return
        _STATE["printed"] = True
        results = dict(_STATE["results"])
        extra = dict(_STATE["extra"])
    if not results:
        return
    top = max(results)
    best = dict(results[top])
    for pri in sorted(results):
        if pri != top:
            r = results[pri]
            best[f"also_{r['metric']}"] = r["value"]
    best.update(extra)
    if "ref_a4_encode_mbps" in best:
        best["vs_reference"] = round(best["value"] / best["ref_a4_encode_mbps"], 2)
    print(json.dumps(best), flush=True)


def _watchdog(deadline: float) -> None:
    time.sleep(max(0.0, deadline - time.time()))
    with _LOCK:
        have = bool(_STATE["results"]) and not _STATE["printed"]
    if have:
        _emit()
        os._exit(0)
    if not _STATE["printed"]:
        os._exit(3)


def _force(out):
    """Force completion by fetching the last (small) output to host.
    Callers arrange for out[-1] to be a scalar or a per-block vector,
    never the payload."""
    return np.asarray(out[-1]).sum()


def _measure(step, arr, size, metric, deadline, iters=3, extra=None, priority=0):
    """Compile + time one jitted step; record best-so-far after every iter."""
    t_c = time.time()
    out = step(arr)
    _force(out)
    compile_s = round(time.time() - t_c, 1)

    times = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        out = step(arr)
        _force(out)
        times.append(time.perf_counter() - t0)
        mbps = size / 1e6 / min(times)
        res = {
            "metric": metric,
            "value": round(mbps, 2),
            "unit": "MB/s",
            "vs_baseline": round(mbps / BASELINE_MBPS, 4),
            "compile_s": compile_s,
            "iters": len(times),
        }
        if extra:
            res.update(extra)
        _record(res, priority)
        if time.time() > deadline - 1.5 * times[-1]:
            break
    # pipelined throughput: K back-to-back dispatches, ONE trailing fetch —
    # how the production container streams blocks.  The per-call host sync
    # amortizes over the pipeline instead of taxing every step; report it
    # when it beats the single-shot number.
    K = min(4, max(2, iters))
    if time.time() < deadline - (K + 1.5) * min(times):
        t0 = time.perf_counter()
        for _ in range(K):
            out = step(arr)
        _force(out)
        pipe_mbps = K * size / 1e6 / (time.perf_counter() - t0)
        if pipe_mbps > size / 1e6 / min(times):
            res = dict(res)
            res["value"] = round(pipe_mbps, 2)
            res["vs_baseline"] = round(pipe_mbps / BASELINE_MBPS, 4)
            res["pipelined"] = K
            _record(res, priority)
    return out


def _v3_step(fwd):
    # direct call of the decorated function (no outer jit): cache entries
    # are shared with any library-path caller; out[-1] (base, an int32
    # scalar) is the completion-forcing fetch
    def step(x):
        out = fwd(x, "small")
        return out[0], out[1]

    return step


def main():
    budget = float(os.environ.get("BENCH_BUDGET", 450))
    deadline = time.time() + budget
    threading.Thread(target=_watchdog, args=(deadline,), daemon=True).start()

    size_cap = int(os.environ.get("BENCH_SIZE", 1 << 26))  # 64 MiB default
    iters = int(os.environ.get("BENCH_ITERS", 3))
    impl = os.environ.get("BENCH_IMPL", "")  # empty = staged auto
    block = int(os.environ.get("BENCH_BLOCK", 1 << 22))

    from archon_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from archon_tpu.utils.corpus import load_or_synthesize

    name, data = load_or_synthesize(size_cap)

    def run_v3(size, priority):
        from archon_tpu.core.fast2 import bwt_v3

        arr = jnp.asarray(np.frombuffer(data[:size], dtype=np.uint8))
        return _measure(
            _v3_step(bwt_v3), arr, size,
            f"forward_bwt_v3_{name}_{size >> 20}MiB", deadline, iters,
            priority=priority,
        )

    def run_single(which, size):
        from archon_tpu.core.bwt import bwt_forward, bwt_forward_fast
        from archon_tpu.core.fast2 import bwt_forward_v2, bwt_v3

        fwd = {"v3": bwt_v3, "v2": bwt_forward_v2,
               "fast": bwt_forward_fast, "plain": bwt_forward}[which]
        arr = jnp.asarray(np.frombuffer(data[:size], dtype=np.uint8))
        return _measure(
            _v3_step(fwd), arr, size,
            f"forward_bwt_{which}_{name}_{size >> 20}MiB", deadline, iters,
        )

    def run_blocks(size, blk=None):
        # the production program: cascade-free fast path (core.batched.
        # bwt_batched_micro), the same graph io/blocks ships.  The marker is
        # written by scripts/compile_blocks_tpu.py after a compile.
        from archon_tpu.core.batched import bwt_batched_micro

        blk = blk or block
        nblocks = max(1, size // blk)
        bsz = min(blk, size)
        size = nblocks * bsz
        blk_data = data
        if len(blk_data) < size:  # marker shape can exceed BENCH_SIZE
            _, blk_data = load_or_synthesize(size)
        arr = jnp.asarray(
            np.frombuffer(blk_data[:size], np.uint8).reshape(nblocks, bsz)
        )

        # NO outer jit wrapper: calling the decorated bwt_batched_micro
        # directly shares its cache entry with the container's io path, so
        # one compile serves both the bench step and `archon e`.
        # out[-1] is the per-block resolved vector — a tiny fetch.
        def step(x):
            return bwt_batched_micro(x, "small")

        out = _measure(
            step, arr, size,
            f"forward_bwt_blocks{bsz >> 20}MiB_{name}_{size >> 20}MiB",
            deadline, iters, priority=3,
        )
        # the program compiled at this (nblocks, bsz): refresh the marker,
        # PRESERVING the e2e flag when the shape is unchanged (dropping it
        # would make the NEXT bench run skip the container stage)
        os.makedirs(os.path.dirname(_BLOCKS_MARKER), exist_ok=True)
        prev = {}
        try:
            with open(_BLOCKS_MARKER) as fh:
                prev = json.load(fh)
        except Exception:
            pass
        same_shape = prev.get("nblocks") == nblocks and prev.get("block") == bsz
        with open(_BLOCKS_MARKER, "w") as fh:
            json.dump(
                {"nblocks": nblocks, "block": bsz, "hash": program_hash(),
                 "files": _file_hashes(_BLOCKS_SOURCES),
                 "e2e": bool(prev.get("e2e")) and same_shape}, fh
            )
        return out

    def run_a6(size):
        from archon_tpu.core.a6 import _a6_symbol_transform

        arr = jnp.asarray(np.frombuffer(data[:size], dtype=np.uint8))
        code_map = jnp.asarray(np.arange(256, dtype=np.uint8))

        def step(x):
            return _a6_symbol_transform(x, code_map)

        return _measure(
            step, arr, size, f"a6_byte_bwt_{name}_{size >> 20}MiB",
            deadline, iters,
        )

    def run_a6_extras(marker):
        """a6 compressor device throughput: byte and var
        configs both run the n-symbol program (the var bit-domain sort
        reduces to it exactly — core/a6._symbol_rank_map), so ONE warmed
        cache entry (scripts/warm_a6.py) serves both; recorded as
        a6_*_mbps fields.  Ref: a6/src/bwt.c:349-439."""
        from archon_tpu.core.a6 import (
            _a6_symbol_transform,
            _symbol_rank_map,
            build_codes,
        )

        def timed(step, arr, size, key):
            out = step(arr)
            float(out[-1])  # warm-cache compile + completion force
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                out = step(arr)
                float(out[-1])
                times.append(time.perf_counter() - t0)
            _record_extra(key, round(size / 1e6 / min(times), 2))

        bsize = int(marker.get("byte_size", 1 << 24))
        d = data
        if len(d) < bsize:
            _, d = load_or_synthesize(bsize)
        npdata = np.frombuffer(d[:bsize], np.uint8)
        arr = jnp.asarray(npdata)
        code_map = jnp.asarray(np.arange(256, dtype=np.uint8))
        timed(
            lambda x: _a6_symbol_transform(x, code_map), arr, bsize,
            "a6_byte_bwt_mbps",
        )
        var_map = jnp.asarray(_symbol_rank_map(build_codes(npdata, "var")))
        timed(
            lambda x: _a6_symbol_transform(x, var_map), arr, bsize,
            "a6_var_bwt_mbps",
        )

        # a6 at the 4 MiB stream-block shape, pipelined (cache-warm)
        if "var_stream4_mbps" in marker and time.time() < deadline - 30:
            s22 = 1 << 22
            arr22 = jnp.asarray(npdata[:s22])
            out = _a6_symbol_transform(arr22, var_map)
            float(out[-1])
            t0 = time.perf_counter()
            for _ in range(4):
                out = _a6_symbol_transform(arr22, var_map)
            float(out[-1])
            _record_extra(
                "a6_var_stream4_mbps",
                round(4 * s22 / 1e6 / (time.perf_counter() - t0), 2),
            )

        # decode + fallback numbers, cache-warm via scripts/warm_a6.py
        from archon_tpu.core.a6 import a6_decode, a6_forward

        if "var_inverse_mbps" in marker and time.time() < deadline - 40:
            out_v, base_v = a6_forward(npdata, "var")
            blob = np.uint32(base_v).tobytes() + out_v.tobytes()
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                a6_decode(blob, "var")
                times.append(time.perf_counter() - t0)
            _record_extra(
                "a6_var_inverse_mbps", round(bsize / 1e6 / min(times), 2)
            )
        if "var_fallback_mbps" in marker and time.time() < deadline - 30:
            fb_size = int(marker.get("fallback_size", 1 << 20))
            fb = np.full(fb_size, 65, np.uint8)
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                a6_forward(fb, "var")
                times.append(time.perf_counter() - t0)
            _record_extra(
                "a6_var_fallback_mbps", round(fb_size / 1e6 / min(times), 2)
            )

    def run_stream(marker):
        """Streamed per-block 1D dispatches (io/blocks impl='stream').
        Dispatches pipeline through the device queue; fetching the LAST
        base forces the whole stream (in-order program execution)."""
        from archon_tpu.core.fast2 import bwt_v3

        bsz = int(marker["block"])
        nb = int(marker["nblocks"])
        size = nb * bsz
        d = data
        if len(d) < size:
            _, d = load_or_synthesize(size)
        blks = [
            jnp.asarray(np.frombuffer(d[i * bsz : (i + 1) * bsz], np.uint8))
            for i in range(nb)
        ]

        def step(_x):
            outs = [bwt_v3(b, "small") for b in blks]
            return outs[-1]  # (L, base); base fetch = stream barrier

        label = (
            f"{bsz >> 20}MiB" if bsz >= (1 << 20) else f"{bsz >> 10}KiB"
        )
        out = _measure(
            step, blks[0], size,
            f"forward_bwt_stream{label}_{name}_{size >> 20}MiB",
            deadline, iters, priority=4,
        )
        # stash the full block set for the decode stage: a single tail
        # block understates the pooled native decode at small block sizes
        if time.time() < deadline - 90:
            try:
                outs = [bwt_v3(b, "small") for b in blks]
                _STREAM_RESULTS.extend(
                    (np.asarray(L), int(b)) for L, b in outs
                )
            except Exception:
                pass
        return out

    out = None
    warm_shape = None
    stream_shape = None
    if impl == "blocks":
        out = run_blocks(size_cap)
    elif impl == "a6":
        out = run_a6(size_cap)
    elif impl in ("v3", "v2", "fast", "plain"):
        out = run_single(impl, size_cap)
    else:
        # staged auto mode (the driver path).  The streamed path (highest
        # measured throughput) headlines when warm; blocks next.
        if os.path.exists(_STREAM_MARKER):
            try:
                with open(_STREAM_MARKER) as fh:
                    sm = json.load(fh)
                if sm.get("hash", "") == program_hash():
                    out = run_stream(sm) or out
                    stream_shape = (int(sm["nblocks"]), int(sm["block"]))
                else:
                    warn_stale(
                        sm, _BLOCKS_SOURCES, "stream",
                        "scripts/warm_stream.py",
                    )
            except Exception as e:  # noqa: BLE001
                print(f"[bench] stream stage failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
        if os.path.exists(_BLOCKS_MARKER):
            try:
                with open(_BLOCKS_MARKER) as fh:
                    m = json.load(fh)
                if m.get("hash", "") == program_hash():
                    # e2e flag: the io-layer program (a distinct HLO from the
                    # bench step) was also warmed by compile_blocks_tpu.py
                    if m.get("e2e"):
                        warm_shape = (m["nblocks"], m["block"])
                    out = run_blocks(m["nblocks"] * m["block"], m["block"]) or out
                else:
                    warn_stale(
                        m, _BLOCKS_SOURCES, "blocks",
                        "scripts/compile_blocks_tpu.py",
                    )
            except Exception:
                pass
    # container end-to-end: the actual `archon e` path — device transform
    # + host framing + device->host payload fetch; reported as an extra,
    # not the headline.  Uses verify=False so the programs are the
    # cache-warm graphs.  Runs through impl="stream" (the same bwt_v3 1D
    # programs warm_stream compiles) when that marker is warm, so the e2e
    # stage does not depend on the batched-program compile; the
    # blocks-marker path remains as a fallback.
    try:
        e2e_shape = stream_shape or warm_shape
        e2e_impl = "stream" if stream_shape else "micro"
        if stream_shape is not None:
            # measure e2e at the container's FORMAT-DEFAULT 4 MiB block when
            # that shape is warm, even if the headline marker sits at a
            # smaller sweep shape: the number should describe the default
            # format
            try:
                with open(_STREAM_MARKER) as fh:
                    wl = json.load(fh).get("blocks_warm", [])
                from archon_tpu.io.blocks import DEFAULT_BLOCK

                if DEFAULT_BLOCK in wl:
                    e2e_shape = (
                        max(1, min(size_cap, 1 << 26) // DEFAULT_BLOCK),
                        DEFAULT_BLOCK,
                    )
            except Exception:
                pass
        if e2e_shape is not None and time.time() < deadline - 60:
            from archon_tpu.io.blocks import encode_file

            nb, bs = e2e_shape
            e2e_n = nb * bs  # exactly the cache-warm program shape
            e2e_data = data
            if len(e2e_data) < e2e_n:
                _, e2e_data = load_or_synthesize(e2e_n)
            # one warm-up call (program load + first-dispatch sync), then
            # the steady-state measurement the production stream runs at
            encode_file(e2e_data[:e2e_n], "a4", block_size=bs, verify=False,
                        impl=e2e_impl)
            t0 = time.perf_counter()
            blob = encode_file(e2e_data[:e2e_n], "a4", block_size=bs,
                               verify=False, impl=e2e_impl)
            dt = time.perf_counter() - t0
            _record_extra("container_encode_e2e_mbps", round(e2e_n / 1e6 / dt, 2))
            _record_extra("container_ratio", round(len(blob) / e2e_n, 4))
            # the COMPRESSING container (ATA2): same device programs plus
            # the host-native threaded pack — the ratio-bearing `archon e
            # --pack` path end-to-end
            if time.time() < deadline - 45:
                t0 = time.perf_counter()
                blob_p = encode_file(e2e_data[:e2e_n], "a4", block_size=bs,
                                     verify=False, impl=e2e_impl, pack=True)
                dt = time.perf_counter() - t0
                _record_extra(
                    "container_packed_e2e_mbps", round(e2e_n / 1e6 / dt, 2)
                )
                _record_extra(
                    "container_packed_e2e_ratio", round(len(blob_p) / e2e_n, 4)
                )
    except Exception as e:  # noqa: BLE001
        print(f"[bench] e2e stage failed: {type(e).__name__}: {e}",
              file=sys.stderr)

    # compression-ratio scoreboard: the ATA2 packed
    # container on MARKUP-shaped synthetic (the enwik8 structure class) —
    # one cache-warm bwt_v3 dispatch for L, then the host pack/unpack
    # (MTF+RLE0+Huffman, native) timed directly.  Plus the a6 var entropy
    # stage's own bits/sym as a ratio.
    try:
        if time.time() < deadline - 45:
            from archon_tpu.core.fast2 import bwt_v3
            from archon_tpu.entropy.pack import pack_block, unpack_block
            from archon_tpu.utils.corpus import markup_like

            bs = 1 << 22  # the warm bwt_v3 shape (scripts/warm_stream.py)
            md = markup_like(bs)
            arr = jnp.asarray(np.frombuffer(md[::-1], np.uint8))
            L, _b = bwt_v3(arr, "small")
            Lh = np.asarray(L)
            t0 = time.perf_counter()
            payload = pack_block(Lh)
            t1 = time.perf_counter()
            back = unpack_block(payload, bs)
            t2 = time.perf_counter()
            assert (back == Lh).all()
            _record_extra(
                "container_packed_ratio", round((len(payload) + 24) / bs, 4)
            )
            _record_extra("pack_native_mbps", round(bs / 1e6 / (t1 - t0), 2))
            _record_extra("unpack_native_mbps", round(bs / 1e6 / (t2 - t1), 2))

            from archon_tpu.utils.tools import huffman_bits_per_sym

            bps = huffman_bits_per_sym(np.frombuffer(md, np.uint8))
            _record_extra("a6_var_code_ratio", round(bps / 8.0, 4))
    except Exception as e:  # noqa: BLE001
        print(f"[bench] pack stage failed: {type(e).__name__}: {e}",
              file=sys.stderr)

    # ATM1 (sharded megablock container) ratio + native recovery-decode
    # MB/s: the encode needs an sp mesh, so a subprocess builds a small
    # ATM1 on a virtual CPU mesh and times the host-native decode — fields
    # merged from its JSON line.  The child forces the CPU before its
    # backend starts, so it never competes for this process's card.
    try:
        if time.time() < deadline - 90:
            import subprocess

            r = subprocess.run(
                [sys.executable, os.path.join(_REPO, "scripts", "atm1_bench.py")],
                capture_output=True, timeout=240, text=True,
            )
            line = (r.stdout.strip().splitlines() or [""])[-1]
            if line.startswith("{"):
                for k, v in json.loads(line).items():
                    _record_extra(k, v)
    except Exception as e:  # noqa: BLE001
        print(f"[bench] atm1 stage failed: {type(e).__name__}: {e}",
              file=sys.stderr)

    # a6 compressor stages (byte 16 MiB + var 4 MiB), warm-cache gated like
    # blocks: scripts/warm_a6.py writes the marker after its compile
    try:
        if impl == "" and os.path.exists(_A6_MARKER) and time.time() < deadline - 90:
            with open(_A6_MARKER) as fh:
                am = json.load(fh)
            if am.get("hash") == program_hash(_A6_SOURCES):
                run_a6_extras(am)
            else:
                warn_stale(am, _A6_SOURCES, "a6", "scripts/warm_a6.py")
    except Exception as e:  # noqa: BLE001
        print(f"[bench] a6 stage failed: {type(e).__name__}: {e}", file=sys.stderr)

    # it2 reduced-volume number: the Itoh-Tanaka fractional-sort
    # candidate, warm-gated like a6 (marker written by scripts/measure_r5.py
    # it2 after its compile).  Production stays bwt_v3 — this field keeps
    # the comparison on the scoreboard.  Ref: a4/src/archon.c:163-194.
    try:
        if impl == "" and os.path.exists(_IT2_MARKER) and time.time() < deadline - 60:
            with open(_IT2_MARKER) as fh:
                im = json.load(fh)
            it2_srcs = _BLOCKS_SOURCES + ("archon_tpu/core/it2.py",)
            if im.get("hash") == program_hash(it2_srcs):
                from archon_tpu.core.it2 import bwt_it2

                i_n = int(im.get("size", 1 << 22))
                i_d = data
                if len(i_d) < i_n:
                    _, i_d = load_or_synthesize(i_n)
                i_arr = jnp.asarray(np.frombuffer(i_d[:i_n], np.uint8))
                out_i = bwt_it2(i_arr, "small")
                int(out_i[1]) + int(out_i[2])  # warm-cache load + force
                times = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    out_i = bwt_it2(i_arr, "small")
                    int(out_i[1]) + int(out_i[2])
                    times.append(time.perf_counter() - t0)
                _record_extra(
                    "it2_bwt_mbps", round(i_n / 1e6 / min(times), 2)
                )
            else:
                warn_stale(im, it2_srcs, "it2", "scripts/measure_r5.py it2")
    except Exception as e:  # noqa: BLE001
        print(f"[bench] it2 stage failed: {type(e).__name__}: {e}",
              file=sys.stderr)

    # bonus metric with leftover budget: the reference a4 binary itself on
    # the SAME data and host (single-core CPU, the hardware class it was
    # written for) — the direct competitor number for vs_reference
    try:
        if time.time() < deadline - 30:
            import pathlib
            import subprocess

            exe = "/tmp/archon-oracles/archon4"
            if not os.path.exists(exe):
                os.makedirs("/tmp/archon-oracles", exist_ok=True)
                srcs = sorted(
                    str(p) for p in pathlib.Path(
                        "/root/reference/bwt/a4/src"
                    ).glob("*.c")
                )
                subprocess.run(
                    ["gcc", "-O2", "-DNDEBUG", "-o", exe] + srcs,
                    check=True, capture_output=True, timeout=60,
                )
            ref_n = min(len(data), 1 << 24)
            pathlib.Path("/tmp/bench_ref.in").write_bytes(data[:ref_n])
            t0 = time.perf_counter()
            subprocess.run(
                [exe, "e", "/tmp/bench_ref.in", "/tmp/bench_ref.enc"],
                check=True, capture_output=True, timeout=120,
            )
            ref_mbps = round(ref_n / 1e6 / (time.perf_counter() - t0), 2)
            _record_extra("ref_a4_encode_mbps", ref_mbps)
            t0 = time.perf_counter()
            subprocess.run(
                [exe, "d", "/tmp/bench_ref.enc", "/tmp/bench_ref.dec"],
                check=True, capture_output=True, timeout=120,
            )
            _record_extra(
                "ref_a4_decode_mbps",
                round(ref_n / 1e6 / (time.perf_counter() - t0), 2),
            )
    except Exception:
        pass

    # host-native decode of the output just produced (the reference ships
    # decode timing too, a4/src/main.c:53)
    try:
        if (out is not None or _STREAM_RESULTS) and time.time() < deadline - 20:
            from archon_tpu import native

            if native.available():
                from concurrent.futures import ThreadPoolExecutor

                if _STREAM_RESULTS:
                    # the full streamed block set (pooled multi-core decode,
                    # the same shape decode_file runs)
                    pairs = _STREAM_RESULTS
                else:
                    L = np.asarray(out[0])
                    base = np.asarray(out[1])
                    if L.ndim == 1:
                        L, base = L[None, :], np.asarray([base])
                    pairs = [(L[b], int(base[b])) for b in range(L.shape[0])]
                total = sum(len(L) for L, _ in pairs)
                t0 = time.perf_counter()
                # the native LF walk releases the GIL; blocks decode on all
                # cores (same pooling as io.blocks.decode_container)
                with ThreadPoolExecutor(
                    max_workers=min(len(pairs), os.cpu_count() or 1)
                ) as ex:
                    list(
                        ex.map(
                            lambda p: native.unbwt(p[0], p[1], False), pairs
                        )
                    )
                dt = time.perf_counter() - t0
                _record_extra("decode_native_mbps", round(total / 1e6 / dt, 2))
    except Exception:
        pass

    # whole-file v3 stages LAST (staged auto mode): their fast2 source may
    # have changed since the cache was warmed, and a cold v3 compile must not
    # cost the headline or the host-side extras recorded above (the watchdog
    # emits everything recorded so far if a compile eats the budget)
    if impl == "":
        stage1 = min(size_cap, 1 << 24)
        if time.time() < deadline - 150:
            out = run_v3(stage1, priority=1) or out
        if size_cap > stage1 and time.time() < deadline - 150:
            out = run_v3(size_cap, priority=2) or out

    _emit()


if __name__ == "__main__":
    main()
