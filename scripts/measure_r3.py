"""Device microbenchmarks of the forward sorter's parts (run standalone,
one process per card).

Stages (each independently guarded; pass stage names as argv to select):
  cummax   - blocked_cummax vs lax.cummax at 2^25 / 2^26
  stages   - micro-program stage attribution at (16, 2^22): bootstrap alone,
             bootstrap+invert+round, vs the full-program number
  sais     - bwt_sais vs bwt_v3 at 2^22

Writes human-readable lines.
"""

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def _t(step, *args, iters=3, pipelined=4):
    out = step(*args)
    _force(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = step(*args)
        _force(out)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(pipelined):
        out = step(*args)
    _force(out)
    pipe = (time.perf_counter() - t0) / pipelined
    return min(times), pipe


def _force(out):
    import jax

    leaves = jax.tree_util.tree_leaves(out)
    x = leaves[-1]
    try:
        float(x.ravel()[0] if hasattr(x, "ravel") else x)
    except Exception:
        import numpy as np

        np.asarray(x)


def main():
    which = set(sys.argv[1:]) or {"cummax", "stages", "sais"}

    import jax

    from archon_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    print(f"[measure] devices={jax.devices()}", flush=True)

    if "cummax" in which:
        from archon_tpu.ops.scan import blocked_cummax

        for logn in (25, 26):
            n = 1 << logn
            rng = np.random.default_rng(0)
            x = jnp.asarray(rng.integers(0, 1 << 30, (1, n), np.int32))

            @jax.jit
            def f_lax(v):
                return lax.cummax(v, axis=1).sum()

            @jax.jit
            def f_blk(v):
                return blocked_cummax(v).sum()

            for name, f in (("lax", f_lax), ("blocked", f_blk)):
                t0 = time.time()
                single, pipe = _t(f, x)
                print(
                    f"[cummax] 2^{logn} {name}: {single*1e3:.1f} ms single, "
                    f"{pipe*1e3:.1f} ms pipelined (compile+iters {time.time()-t0:.0f}s)",
                    flush=True,
                )

    if "stages" in which:
        from archon_tpu.core import batched as B
        from archon_tpu.utils.corpus import load_or_synthesize

        nblocks, blog = 16, 22
        size = nblocks << blog
        _, data = load_or_synthesize(size)
        arr = jnp.asarray(
            np.frombuffer(data[:size], np.uint8).reshape(nblocks, 1 << blog)
        )

        @jax.jit
        def boot(x):
            prev2 = jnp.roll(x, 1, axis=1)
            si, rs, ac, na, prev_s = B._bootstrap_sorted2(x, prev2, "small")
            return rs.sum() + na.sum()

        @jax.jit
        def boot_round(x):
            prev2 = jnp.roll(x, 1, axis=1)
            si, rs, ac, na, prev_s = B._bootstrap_sorted2(x, prev2, "small")
            si, rs, ac, na, prev_s, rank = B._round_full_sorted2(
                si, rs, prev2, jnp.int32(12), "small"
            )
            return rs.sum() + na.sum() + rank.sum()

        for name, f in (("bootstrap", boot), ("bootstrap+round", boot_round)):
            t0 = time.time()
            single, pipe = _t(f, arr)
            print(
                f"[stages] (16,2^22) {name}: {single*1e3:.0f} ms single, "
                f"{pipe*1e3:.0f} ms pipelined (compile+iters {time.time()-t0:.0f}s)",
                flush=True,
            )

    if "sais" in which:
        from archon_tpu.core.sais_tpu import bwt_sais
        from archon_tpu.core.fast2 import bwt_v3
        from archon_tpu.utils.corpus import load_or_synthesize

        n = 1 << 22
        _, data = load_or_synthesize(n)
        arr = jnp.asarray(np.frombuffer(data[:n], np.uint8))

        @jax.jit
        def f_sais(x):
            L, base = bwt_sais(x, "small")
            return L.astype(jnp.int32).sum() + base

        @jax.jit
        def f_v3(x):
            out = bwt_v3(x, "small")
            return out[0].astype(jnp.int32).sum() + out[1]

        for name, f in (("bwt_v3", f_v3), ("bwt_sais", f_sais)):
            t0 = time.time()
            try:
                single, pipe = _t(f, arr)
                print(
                    f"[sais] 2^22 {name}: {single*1e3:.0f} ms single, "
                    f"{pipe*1e3:.0f} ms pipelined (compile+iters {time.time()-t0:.0f}s)",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 - record and continue
                print(f"[sais] 2^22 {name}: FAILED after {time.time()-t0:.0f}s: "
                      f"{type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
