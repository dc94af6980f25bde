"""Device measurements of the candidate sorters and block sizes (run each
subcommand on its own, one process per card).

Subcommands:
  it2 [log2n]    - bwt_it2 vs bwt_v3 at 2^log2n (default 22), single-shot
                   and pipelined; writes bench.py's it2 marker.
  sais [log2n]   - bwt_sais vs bwt_v3 at a small size (default 2^18).
  a6break [log2n]- a6 symbol-path overhead attribution: bwt_v3 vs
                   bwt_v3_payload(recoded) vs full _a6_symbol_transform.
  gather256      - the a6 symbol remap as a plain gather vs one-hot compare.
  sweep          - streamed block-size sweep: 4 MiB vs 2 MiB vs 1 MiB blocks
                   at 64 MiB total.
"""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _setup():
    import jax

    from archon_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    return jax


def _data_arr(n):
    import jax.numpy as jnp
    import numpy as np

    from archon_tpu.utils.corpus import load_or_synthesize

    _, data = load_or_synthesize(n)
    return jnp.asarray(np.frombuffer(data[:n], np.uint8))


def _time(label, step, force, iters=3, pipe=4):
    t0 = time.time()
    out = step()
    force(out)
    compile_s = time.time() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step()
        force(out)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(pipe):
        out = step()
    force(out)
    piped = (time.perf_counter() - t0) / pipe
    print(
        f"[{label}] compile {compile_s:.0f}s, single {min(times)*1e3:.1f} ms, "
        f"pipelined {piped*1e3:.1f} ms", flush=True,
    )
    return min(times), piped


def cmd_it2(log2n=22):
    _setup()
    from archon_tpu.core.fast2 import bwt_v3
    from archon_tpu.core.it2 import bwt_it2

    n = 1 << log2n
    arr = _data_arr(n)
    mb = n / 1e6

    s_v3, p_v3 = _time("v3", lambda: bwt_v3(arr, "small"), lambda o: int(o[1]))
    s_it, p_it = _time(
        "it2", lambda: bwt_it2(arr, "small"), lambda o: int(o[1]) + int(o[2])
    )
    # windowed async form (how the streamed container dispatches it2):
    # all dispatches enqueue before the first na fetch, so device work
    # overlaps the residual-decision round-trips
    from archon_tpu.core.it2 import bwt_it2_async

    W = 4
    fins = [bwt_it2_async(arr, "small") for _ in range(W)]
    [f() for f in fins]  # warm
    t0 = time.perf_counter()
    fins = [bwt_it2_async(arr, "small") for _ in range(W)]
    outs = [f() for f in fins]
    p_async = (time.perf_counter() - t0) / W
    print(
        f"[it2] async window {W}: {p_async*1e3:.1f} ms/block = "
        f"{mb/p_async:.1f} MB/s", flush=True,
    )

    # confirm the fast path actually resolved (ok=True) on this corpus
    ok = bool(bwt_it2(arr, "small")[2])
    print(
        f"[it2] n=2^{log2n}: ok={ok}; v3 {mb/p_v3:.1f} MB/s vs it2 "
        f"{mb/p_it:.1f} MB/s (pipelined); ratio it2/v3 = {p_it/p_v3:.2f}x",
        flush=True,
    )
    # write the bench marker: the it2 programs are now compiled, so bench
    # records the reduced-volume number (it2_bwt_mbps)
    import json

    import bench as bench_mod

    marker = os.path.join(_REPO, ".jax_cache", "it2_warm.marker")
    os.makedirs(os.path.dirname(marker), exist_ok=True)
    srcs = bench_mod._BLOCKS_SOURCES + ("archon_tpu/core/it2.py",)
    with open(marker, "w") as fh:
        json.dump(
            {
                "size": n,
                "mbps": round(mb / p_it, 2),
                "ok": ok,
                "hash": bench_mod.program_hash(srcs),
                "files": bench_mod._file_hashes(srcs),
            },
            fh,
        )
    print(f"[it2] marker written: {marker}", flush=True)


def cmd_sais(log2n=18):
    _setup()
    from archon_tpu.core.fast2 import bwt_v3
    from archon_tpu.core.sais_tpu import bwt_sais

    n = 1 << log2n
    arr = _data_arr(n)
    mb = n / 1e6
    s_v3, p_v3 = _time("v3", lambda: bwt_v3(arr, "small"), lambda o: int(o[1]))
    s_sa, p_sa = _time("sais", lambda: bwt_sais(arr, "small"), lambda o: int(o[1]))
    print(
        f"[sais] n=2^{log2n}: v3 {mb/p_v3:.1f} MB/s vs sais {mb/p_sa:.1f} "
        f"MB/s (pipelined)", flush=True,
    )


def cmd_a6break(log2n=24):
    _setup()
    import jax.numpy as jnp
    import numpy as np

    from archon_tpu.core.a6 import _a6_symbol_transform
    from archon_tpu.core.fast2 import bwt_v3, bwt_v3_payload

    n = 1 << log2n
    arr = _data_arr(n)
    mb = n / 1e6
    code_map = jnp.asarray(np.arange(256, dtype=np.uint8))

    _, p1 = _time("v3-large", lambda: bwt_v3(arr, "large"), lambda o: int(o[1]))
    pay = jnp.roll(arr[::-1], 1)

    def step_payload():
        return bwt_v3_payload(arr, pay, "large")

    _, p2 = _time("v3-payload-large", step_payload, lambda o: int(o[1]))

    def step_full():
        return _a6_symbol_transform(arr, code_map)

    _, p3 = _time("a6-symbol-full", step_full, lambda o: int(o[1]))
    print(
        f"[a6break] n=2^{log2n}: v3 {mb/p1:.1f} | +external payload "
        f"{mb/p2:.1f} | +recode/reverse {mb/p3:.1f} MB/s", flush=True,
    )


def cmd_gather256(log2n=24):
    """Probe lowerings for the a6 symbol remap (a 256-entry permutation
    gather over n bytes): plain take vs one-hot masked-sum (no gather
    HLO)."""
    _setup()
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    n = 1 << log2n
    arr = _data_arr(n)
    table = jnp.asarray(np.random.default_rng(0).permutation(256).astype(np.uint8))

    @jax.jit
    def via_gather(c, t):
        return t[c]

    @jax.jit
    def via_onehot(c, t):
        # n x 256 compare + masked sum, fused row-wise by XLA (no gather)
        i = jnp.arange(256, dtype=jnp.uint8)
        return jnp.sum(
            jnp.where(c[:, None] == i[None, :], t[None, :], jnp.uint8(0)),
            axis=1,
        )

    for label, fn in (("take", via_gather), ("onehot", via_onehot)):
        _time(f"gather256-{label}", lambda fn=fn: fn(arr, table),
              lambda o: int(o[0]) + int(o[-1]))


def cmd_sweep(blogs=(22, 21, 20)):
    _setup()
    from archon_tpu.core.fast2 import bwt_v3

    total = 1 << 26
    arr_full = _data_arr(total)
    for blog in blogs:
        bsz = 1 << blog
        nb = total >> blog
        blks = [arr_full[i * bsz : (i + 1) * bsz] for i in range(nb)]

        def step():
            outs = [bwt_v3(b, "small") for b in blks]
            return outs[-1]

        t0 = time.time()
        out = step()
        int(out[1])
        compile_s = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = step()
            int(out[1])
            times.append(time.perf_counter() - t0)
        mbps = total / 1e6 / min(times)
        print(
            f"[sweep] {nb}x{bsz >> 20}MiB: compile {compile_s:.0f}s, "
            f"{min(times)*1e3:.0f} ms = {mbps:.1f} MB/s", flush=True,
        )


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "it2"
    arg = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if cmd == "it2":
        cmd_it2(arg or 22)
    elif cmd == "sais":
        cmd_sais(arg or 18)
    elif cmd == "a6break":
        cmd_a6break(arg or 24)
    elif cmd == "sweep":
        cmd_sweep()
    elif cmd == "sweep2":
        cmd_sweep((19, 18))
    elif cmd == "sweep3":
        cmd_sweep((17,))
    elif cmd == "gather256":
        cmd_gather256(arg or 24)
    else:
        raise SystemExit(f"unknown subcommand {cmd}")


if __name__ == "__main__":
    main()
