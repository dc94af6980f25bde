"""Stage timing / tracing (SURVEY.md section 5 observability parity).

The reference wraps every stage in clock() spans and prints per-stage times
plus derived metrics (a4 printime, a4/src/main.c:9-14; a5's per-stage
"Stage k" report and "Linear coef" ms/MB, a5/src/archon.c:161-192; a6's
transform-vs-IO split, a6/src/main.c:160-174).  ``StageTimer`` reproduces
that reporting; ``profile_trace`` wraps jax.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Collects named stage durations; prints an a4/a5-style report."""

    def __init__(self, total_bytes: int = 0):
        self.stages: list[tuple[str, float]] = []
        self.total_bytes = total_bytes
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        yield
        self.stages.append((name, time.perf_counter() - t))

    def report(self, out=print):
        total = time.perf_counter() - self._t0
        for name, dt in self.stages:
            out(f"{name} time: {dt:.3f} sec")
        out(f"Total time: {total:.3f} sec")
        if self.total_bytes:
            mb = self.total_bytes / 1e6
            out(f"Linear coef: {total * 1e3 / max(mb, 1e-9):.2f} ms/MB "
                f"({mb / max(total, 1e-9):.1f} MB/s)")


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """jax.profiler trace around a region (no-op when logdir is None)."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
