"""Shared test fixtures.

- Forces JAX onto a virtual 8-device CPU mesh so sharding/collective logic is
  exercised without an accelerator (SURVEY.md section 4: multi-node testing).
- Builds the reference Archon binaries (a4/a6/a7) from /root/reference into a
  temp dir as byte-exactness oracles.  Tests that need them skip gracefully
  when the reference tree or a toolchain is unavailable.
- ``gpu_card``: fixture of the tests marked ``gpu``, which need an NVIDIA
  card; it skips them where ``nvidia-smi`` sees none.
"""

import os

# The suite runs on an 8-device CPU mesh even on a machine with GPUs: the
# sharding tests need 8 devices, and the CPU results are the reference.  The
# config updates below run before any backend initializes, so they hold
# whatever the caller's environment says.
os.environ["JAX_PLATFORMS"] = "cpu"
# NO persistent compilation cache here, in this process or in the CLI
# subprocesses that inherit this environment (utils/cache.py honors it):
# this jax build's XLA:CPU executable
# (de)serialization segfaults on the largest programs in this suite (seen in
# both put_executable_and_time and get_executable_and_time) — a cache makes
# the suite LESS stable, not faster.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_compilation_cache", False)

# Separately, a long test process very
# occasionally segfaults inside backend_compile on the biggest programs
# (core/sais_tpu) when they compile after ~85 other programs; compiling
# them FIRST in the fresh process avoids the only ordering ever observed to
# crash — see pytest_collection_modifyitems below.


import pytest


def pytest_collection_modifyitems(config, items):
    heavy = ("test_sais_tpu", "test_batched", "test_megablock")
    items.sort(
        key=lambda it: 0 if any(h in it.nodeid for h in heavy) else 1
    )


@pytest.fixture(autouse=True, scope="module")
def _release_jit_memory():
    """Drop compiled executables between test modules.  One process
    compiling the whole suite's ~hundred large programs exhausts XLA:CPU's
    JIT (segfault/abort inside backend_compile, always on whichever big
    program compiles late); releasing each module's executables keeps the
    high-water mark bounded."""
    yield
    jax.clear_caches()

import shutil
import subprocess
from pathlib import Path

import pytest

REFERENCE = Path(os.environ.get("ARCHON_REFERENCE", "/root/reference"))
ORACLE_DIR = Path("/tmp/archon-oracles")


def _build(name: str, sources: list[Path], cc: str) -> Path | None:
    exe = ORACLE_DIR / name
    if exe.exists():
        return exe
    ORACLE_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cc, "-O2", "-DNDEBUG", "-o", str(exe)] + [str(s) for s in sources]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        return None
    return exe if exe.exists() else None


def _patched_a6_sources() -> list[Path]:
    """a6 was written for 32-bit targets: its ``typedef unsigned long dword``
    (common.h) becomes 8 bytes on LP64, making every key read garbage (it
    segfaults on any input).  The faithful oracle is the 32-bit-semantics
    build: patch dword to unsigned int (and the IT-1 ``long diff`` wraparound
    test, bwt.c:394, back to 32-bit signed)."""
    dst = ORACLE_DIR / "a6src"
    ORACLE_DIR.mkdir(parents=True, exist_ok=True)
    if not dst.is_dir():
        import shutil as _sh

        _sh.copytree(REFERENCE / "bwt/a6/src", dst)
        common = dst / "common.h"
        common.write_text(
            common.read_text().replace(
                "typedef unsigned long dword;", "typedef unsigned int dword;"
            )
        )
        bwt = dst / "bwt.c"
        bwt.write_text(bwt.read_text().replace("long diff = ", "int diff = "))
    return sorted(dst.glob("*.c"))


@pytest.fixture(scope="session")
def oracles():
    """dict of reference binaries {'a4': path, 'a6': path, 'a7': path}."""
    if not REFERENCE.is_dir() or not (shutil.which("gcc") and shutil.which("g++")):
        pytest.skip("reference tree or toolchain unavailable")
    out = {}
    a4 = _build("archon4", sorted((REFERENCE / "bwt/a4/src").glob("*.c")), "gcc")
    a6 = _build("archon6", _patched_a6_sources(), "gcc")
    a7 = _build("archon7", sorted((REFERENCE / "bwt/a7/src").glob("*.cpp")), "g++")
    if a4:
        out["a4"] = a4
    if a6:
        out["a6"] = a6
    if a7:
        out["a7"] = a7
    if not out:
        pytest.skip("could not build any reference oracle")
    return out


@pytest.fixture
def gpu_card():
    """Name of the first NVIDIA card; skips the test where there is none.
    The suite's own process stays on the CPU mesh, so a ``gpu`` test runs
    its work in a child process of its own."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired):
        pytest.skip("no NVIDIA card: nvidia-smi is not available")
    if out.returncode != 0 or not out.stdout.strip():
        pytest.skip("no NVIDIA card visible to nvidia-smi")
    return out.stdout.splitlines()[0].strip()


def run_oracle(exe, mode: str, data: bytes, extra_args: list[str] = (), tmpdir=None) -> bytes:
    """Run a reference binary on ``data``; returns the output file bytes."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=tmpdir) as td:
        src = Path(td) / "in.bin"
        dst = Path(td) / "out.bin"
        src.write_bytes(data)
        cmd = [str(exe), mode, str(src), str(dst)] + list(extra_args)
        proc = subprocess.run(cmd, capture_output=True, timeout=300)
        if proc.returncode != 0:
            # The reference a7 binary genuinely segfaults on several input
            # classes (monotonically non-increasing strings; larger exactly
            # periodic strings).  Byte-exactness is undefined there.
            raise OracleCrash(
                f"oracle {exe} rc={proc.returncode}: {proc.stdout[-200:]} {proc.stderr[-200:]}"
            )
        return dst.read_bytes()


class OracleCrash(RuntimeError):
    pass
