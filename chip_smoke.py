"""Smoke run of the encode/decode path on an NVIDIA GPU.

Drives every user entry point once, in ONE process, at the sizes users run
(64 MiB files, the container's default 4 MiB blocks), and checks every
result byte for byte against the golden numpy models (archon_tpu/golden)
or by a round trip.  Each phase prints one JSON line with its sizes, wall
seconds and first-call (compile-included) seconds, beside the card's name
and power limit.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

and is printed only when every phase passed.  Without a GPU, or when any
phase raises or disagrees, the script exits non-zero without it.

    python chip_smoke.py             # the one-card phases
    python chip_smoke.py --cards 4   # only the --dp and --sp paths over four
                                     # cards, with their one-card references

The phase functions take their sizes as arguments, so the CPU tests run
the same code at small sizes (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from archon_tpu.golden import a6 as golden_a6
from archon_tpu.golden import sa as golden_sa
from archon_tpu.utils.corpus import gauntlet_cases, markup_like, text_like

MiB = 1 << 20
EDGE_LENGTHS = (1, 2, 17, 4097, 65537)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, round(time.perf_counter() - t0, 3)


def _same(got: bytes, want: bytes, what: str) -> None:
    if got != want:
        n = min(len(got), len(want))
        diff = next((i for i in range(n) if got[i] != want[i]), n)
        raise AssertionError(
            f"{what}: outputs differ (lengths {len(got)} vs {len(want)}, "
            f"first difference at byte {diff})"
        )


def _golden_encode(data: bytes, generation: str) -> bytes:
    return {"a4": golden_sa.a4_encode, "a7": golden_sa.a7_encode}[generation](data)


def _container_prefix(blob: bytes, nblocks: int) -> bytes:
    """Header plus the first ``nblocks`` frames of an ATA1 container: the
    container of the input's first ``nblocks`` blocks (blocks transform
    independently)."""
    pos = 12
    for _ in range(nblocks):
        pos += 8 + int.from_bytes(blob[pos : pos + 4], "little")
    return blob[:pos]


def phase_container(total=64 * MiB, block=None, generation="a4", pack=False,
                    corpus=text_like):
    """``encode_file`` with the defaults a user gets (default impl,
    ``verify=True``), then ``decode_file``.  Block 0's payload and base
    must equal the golden model's on that block."""
    from archon_tpu.io.blocks import (
        DEFAULT_BLOCK, decode_file, encode_file, extract_block,
    )

    block = block or DEFAULT_BLOCK
    data = corpus(total)
    head = data[:block]
    kw = dict(generation=generation, block_size=block, pack=pack)
    # the golden model runs on a host thread while the device compiles
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(_golden_encode, head, generation)
        blob, first = _timed(lambda: encode_file(data, **kw))
        _, warm = _timed(lambda: encode_file(data, **kw))
        back, dec = _timed(lambda: decode_file(blob))
        _same(back, data, "container round trip")
        _same(extract_block(blob, 0), want.result(), "block 0 vs golden")
    info = {"bytes": total, "block": block, "generation": generation,
            "pack": pack, "golden_bytes": len(head),
            "encode_first_call_s": first, "encode_warm_s": warm,
            "decode_s": dec, "ratio": round(len(blob) / total, 4)}
    return info, blob


def phase_container_a7_packed(total=64 * MiB, block=None):
    """The compressing container (ATA2) in the a7 convention on markup."""
    return phase_container(total, block, generation="a7", pack=True,
                           corpus=markup_like)


def phase_impls(total=16 * MiB, block=None, ref=None):
    """Every other ``--impl`` on the same input: identical container bytes
    to the default impl's (``ref``; computed here when not given)."""
    from archon_tpu.io.blocks import DEFAULT_BLOCK, decode_file, encode_file

    block = block or DEFAULT_BLOCK
    data = text_like(total)
    if ref is None:
        ref = encode_file(data, block_size=block)
    info = {"bytes": total, "block": block}
    for impl in ("stream", "v3", "it2"):
        blob, first = _timed(lambda: encode_file(data, block_size=block, impl=impl))
        _same(blob, ref, f"impl={impl} vs default impl")
        _, warm = _timed(lambda: encode_file(data, block_size=block, impl=impl))
        info[impl] = {"first_call_s": first, "warm_s": warm}
    _same(decode_file(ref), data, "container round trip")
    return info


def phase_formats(total=16 * MiB):
    """The single-block a4/a7 formats (``archon_tpu.encode``/``decode``),
    decoded on the host and on the device (``core/unbwt.bwt_inverse``);
    the encode equals the golden model's on the whole input (computed on
    a host thread while the device compiles)."""
    import archon_tpu

    data = text_like(total)
    info = {"bytes": total, "golden_bytes": total}
    with ThreadPoolExecutor(1) as pool:
        wants = {gen: pool.submit(_golden_encode, data, gen)
                 for gen in ("a4", "a7")}
        for gen in ("a4", "a7"):
            blob, first = _timed(lambda: archon_tpu.encode(data, gen))
            host, host_s = _timed(
                lambda: archon_tpu.decode(blob, gen, device=False))
            _same(host, data, f"{gen} host decode")
            dev, dev_first = _timed(
                lambda: archon_tpu.decode(blob, gen, device=True))
            _same(dev, data, f"{gen} device decode")
            _same(blob, wants[gen].result(), f"{gen} vs golden")
            info[gen] = {"encode_first_call_s": first, "host_decode_s": host_s,
                         "device_decode_first_call_s": dev_first}
    return info


def phase_edges(gauntlet_size=1 << 12, lengths=EDGE_LENGTHS):
    """Repetition pathologies and odd lengths through ``formats.encode``
    (a4) and the streamed container (a7), both against the golden model.
    Every program compiles once per input length, so the few gauntlet
    cases a period leaves short are extended periodically to the common
    length."""
    from archon_tpu import formats
    from archon_tpu.io.blocks import decode_file, encode_file, extract_block

    cases = {name: (x * 2)[:gauntlet_size]
             for name, x in gauntlet_cases(gauntlet_size).items()}
    for n in lengths:
        cases[f"text_{n}"] = text_like(n, seed=n)
    for name, x in cases.items():
        _same(formats.encode(x, "a4"), golden_sa.a4_encode(x), f"{name} a4")
        blob = encode_file(x, "a7", block_size=max(len(x), 1), impl="stream")
        _same(extract_block(blob, 0), golden_sa.a7_encode(x), f"{name} a7 stream")
        _same(decode_file(blob), x, f"{name} a7 round trip")
    return {"cases": len(cases), "gauntlet_size": gauntlet_size,
            "lengths": list(lengths)}


def phase_a6(total=4 * MiB, golden_n=1 * MiB):
    """The a6 compressor for each coder: round trip at ``total``, golden
    a6 byte for byte on a ``golden_n`` prefix (the bit-domain golden sort
    is too slow for 4 MiB)."""
    from archon_tpu.core.a6 import a6_decode, a6_encode

    coders = ("byte", "fix", "var")
    data = text_like(total)
    head = data[:golden_n]
    info = {"bytes": total, "golden_bytes": golden_n}
    with ThreadPoolExecutor(1) as pool:
        wants = {c: pool.submit(golden_a6.a6_encode, head, c) for c in coders}
        for coder in coders:
            blob, first = _timed(lambda: a6_encode(data, coder))
            back, dec = _timed(lambda: a6_decode(blob, coder))
            _same(back, data, f"a6 {coder} round trip")
            _same(a6_encode(head, coder), wants[coder].result(),
                  f"a6 {coder} vs golden")
            info[coder] = {"encode_first_call_s": first, "decode_s": dec,
                           "ratio": round(len(blob) / total, 4)}
    return info


def phase_cli(total=16 * MiB, block=None):
    """``archon e`` then ``archon d`` through ``cli.main``, in process."""
    from archon_tpu.cli import main

    data = text_like(total, seed=3)
    extra = ["-b", str(block)] if block else []
    with tempfile.TemporaryDirectory() as td:
        src, enc, dec = (os.path.join(td, f) for f in ("in", "in.ata", "out"))
        with open(src, "wb") as f:
            f.write(data)
        rc, first = _timed(lambda: main(["e", src, enc] + extra))
        if rc != 0:
            raise AssertionError(f"archon e exited {rc}")
        rc, dec_s = _timed(lambda: main(["d", enc, dec]))
        if rc != 0:
            raise AssertionError(f"archon d exited {rc}")
        with open(dec, "rb") as f:
            _same(f.read(), data, "cli round trip")
    return {"bytes": total, "encode_first_call_s": first, "decode_s": dec_s}


def phase_dp(cards, total=64 * MiB, block=None):
    """``encode_file(dp=cards)``: the container must equal the one-device
    container of the same input, computed in the same run."""
    import jax

    from archon_tpu.io.blocks import DEFAULT_BLOCK, decode_file, encode_file

    block = block or DEFAULT_BLOCK
    if jax.device_count() < cards:
        raise AssertionError(f"dp={cards} needs {cards} devices, "
                             f"have {jax.device_count()}")
    data = text_like(total)
    one, one_s = _timed(lambda: encode_file(data, block_size=block))
    many, first = _timed(lambda: encode_file(data, block_size=block, dp=cards))
    _same(many, one, f"dp={cards} vs one device")
    # the one-device encode ran on device 0 only, so every other device's
    # peak memory shows whether the dp program really ran there (a CPU
    # backend reports no memory stats)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:cards]]
    if None not in peaks and min(peaks) == 0:
        raise AssertionError(f"dp={cards} left a device unused: peaks {peaks}")
    _, warm = _timed(lambda: encode_file(data, block_size=block, dp=cards))
    _same(decode_file(many), data, "dp container round trip")
    return {"bytes": total, "block": block, "dp": cards,
            "one_device_first_call_s": one_s, "dp_first_call_s": first,
            "dp_warm_s": warm, "peak_bytes_per_device": peaks}


def phase_sp(cards, total=64 * MiB):
    """The sharded megablock over an ``sp`` mesh of ``cards`` devices: its
    BWT payload equals one-device ``bwt_v3`` on the same text, and
    ``encode_megablock``/``decode_megablock`` round-trip."""
    import jax
    import jax.numpy as jnp

    from archon_tpu.core.fast2 import bwt_v3
    from archon_tpu.parallel.blocks import make_mesh
    from archon_tpu.parallel.megablock import bwt_megablock
    from archon_tpu.parallel.megapipe import decode_megablock, encode_megablock

    mesh = make_mesh({"sp": cards}, devices=jax.devices()[:cards])
    if mesh.devices.size != cards:
        raise AssertionError(f"sp mesh has {mesh.devices.size} devices, "
                             f"wanted {cards}")
    data = text_like(total)
    view = np.frombuffer(data[::-1], np.uint8)
    (L, base), first = _timed(lambda: bwt_megablock(view, mesh, "small"))
    used = len(L.sharding.device_set)
    if used != cards:
        raise AssertionError(f"megablock payload on {used} devices, not {cards}")
    (L1, b1), one_s = _timed(
        lambda: jax.block_until_ready(bwt_v3(jnp.asarray(view), "small")))
    _same(np.asarray(L).tobytes(), np.asarray(L1).tobytes(),
          "megablock payload vs one-device bwt_v3")
    if base != int(b1):
        raise AssertionError(f"megablock base {base} != bwt_v3 base {int(b1)}")
    blob, enc = _timed(lambda: encode_megablock(data, mesh, "a4"))
    back, dec = _timed(lambda: decode_megablock(blob))
    _same(back, data, "megablock round trip")
    return {"bytes": total, "sp": cards, "megablock_first_call_s": first,
            "one_device_bwt_v3_first_call_s": one_s, "encode_s": enc,
            "decode_s": dec, "ratio": round(len(blob) / total, 4)}


def _one_card_phases():
    """(name, thunk) per phase at chip sizes; the impls phase reuses the
    container phase's output as its reference."""
    state = {}

    def container():
        info, state["blob"] = phase_container()
        return info

    def impls():
        from archon_tpu.io.blocks import DEFAULT_BLOCK

        n = 16 * MiB
        ref = _container_prefix(state["blob"], n // DEFAULT_BLOCK)
        return phase_impls(n, ref=ref)

    return [
        ("container", container),
        ("container_a7_packed", lambda: phase_container_a7_packed()[0]),
        ("impls", impls),
        ("formats", phase_formats),
        ("edges", phase_edges),
        ("a6", phase_a6),
        ("cli", phase_cli),
    ]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4: run only the --dp and --sp paths over four cards")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (default device: {devices[0]})",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(devices)}", file=sys.stderr)
        return 1

    from archon_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    card = _card()
    print(f"card: {card}", flush=True)
    print(json.dumps({"jax": jax.__version__, "devices": [str(d) for d in devices],
                      "compile_cache": cache}), flush=True)

    if args.cards > 1:
        phases = [("dp", lambda: phase_dp(args.cards)),
                  ("sp", lambda: phase_sp(args.cards))]
    else:
        phases = _one_card_phases()
    for name, run in phases:
        t0 = time.perf_counter()
        info = run()
        info = {"phase": name, **info,
                "wall_s": round(time.perf_counter() - t0, 3), "card": card}
        print(json.dumps(info), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
