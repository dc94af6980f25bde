"""chip_smoke.py: its phases at small sizes on the CPU, its refusal to run
without a GPU, and (marked ``gpu``) the whole script on a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

KiB = 1 << 10

# one case per phase of the one-card run, each at <= 64 KiB
PHASES = {
    "container": lambda: chip_smoke.phase_container(64 * KiB, block=16 * KiB),
    "container_a7_packed": lambda: chip_smoke.phase_container_a7_packed(
        64 * KiB, block=16 * KiB),
    "impls": lambda: chip_smoke.phase_impls(32 * KiB, block=16 * KiB),
    "formats": lambda: chip_smoke.phase_formats(16 * KiB),
    "edges": lambda: chip_smoke.phase_edges(
        gauntlet_size=512, lengths=(1, 2, 17, 257)),
    "a6": lambda: chip_smoke.phase_a6(16 * KiB, golden_n=4 * KiB),
    "cli": lambda: chip_smoke.phase_cli(32 * KiB, block=16 * KiB),
}


def test_phases_cover_the_one_card_run():
    assert [name for name, _ in chip_smoke._one_card_phases()] == list(PHASES)


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_small_on_cpu(phase):
    out = PHASES[phase]()
    info = out[0] if isinstance(out, tuple) else out
    json.dumps(info)  # every phase line must serialize


@pytest.mark.parametrize("phase", ["dp", "sp"])
def test_four_card_phase_on_cpu_mesh(phase):
    """The --cards 4 phases on four of the suite's 8 CPU devices."""
    if phase == "dp":
        info = chip_smoke.phase_dp(4, total=64 * KiB, block=16 * KiB)
    else:
        info = chip_smoke.phase_sp(4, total=64 * KiB)
    assert info[phase] == 4


def test_container_prefix_matches_shorter_input():
    from archon_tpu.io.blocks import encode_file
    from archon_tpu.utils.corpus import text_like

    data = text_like(5 * 1024)
    full = encode_file(data, block_size=1024, impl="stream")
    assert chip_smoke._container_prefix(full, 2) == encode_file(
        data[:2048], block_size=1024, impl="stream")


def test_same_reports_first_difference():
    chip_smoke._same(b"abc", b"abc", "equal")
    with pytest.raises(AssertionError, match="first difference at byte 1"):
        chip_smoke._same(b"abc", b"axc", "x")


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _ok_line(stdout: str) -> bool:
    return any('"ok"' in line for line in stdout.splitlines())


def test_main_fails_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = _run(REPO, env)
    assert r.returncode != 0
    assert not _ok_line(r.stdout)
    assert "no GPU" in r.stderr


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert not _ok_line(r.stdout)


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole one-card run; the suite's own process stays on the CPU,
    so the script gets a process (and the card) of its own."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_ENABLE_COMPILATION_CACHE")}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1500,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
