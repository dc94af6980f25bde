"""Command-line interface.

Mirrors each reference generation's own CLI so a reference user can switch
without relearning flags, and adds the native blocked container:

  archon a4 e|d <in> <out>              # a4-compatible (a4/src/main.c:27)
  archon a7 e|d <in> <out>              # a7-compatible (a7/src/main.cpp:7)
  archon a6 <in> <out> [-c byte|fix|var] [-r N] [-o ORDER] [-u]
                                        # a6-compatible (a6/src/main.c:117-123)
  archon e|d <in> <out> [-g a4|a7] [-b BLOCK]
                                        # native block-streamed container
"""

from __future__ import annotations

import argparse
import sys
import time


def _rw_timed(args, fn, profile_dir=None):
    """Read-transform-write with the a4/a5-style per-stage report
    (a5/src/archon.c:161-192 "Stage k" + "Linear coef" ms/MB)."""
    from .utils.timing import StageTimer, profile_trace

    timer = StageTimer()
    with timer.stage("Read"):
        with open(args.infile, "rb") as f:
            data = f.read()
    timer.total_bytes = len(data)
    # --profile-dir / ARCHON_PROFILE_DIR: jax.profiler trace of the transform
    with timer.stage("Transform"):
        with profile_trace(profile_dir):
            out = fn(data)
    with timer.stage("Write"):
        with open(args.outfile, "wb") as f:
            f.write(out)
    print(f"{len(data)} -> {len(out)} bytes")
    timer.report()


def main(argv=None):
    p = argparse.ArgumentParser(prog="archon", description=__doc__)
    p.add_argument(
        "--profile-dir", default=None,
        help="write a jax.profiler trace of the transform stage here "
        "(also honors ARCHON_PROFILE_DIR)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    for gen in ("a4", "a7"):
        g = sub.add_parser(gen, help=f"{gen}-compatible single-block format")
        g.add_argument("mode", choices=["e", "d"])
        g.add_argument("infile")
        g.add_argument("outfile")
        g.add_argument(
            "--no-verify",
            action="store_true",
            help="skip the always-on LF certificate (reference builds keep it compiled in)",
        )

    g6 = sub.add_parser("a6", help="a6-compatible format")
    g6.add_argument("infile")
    g6.add_argument("outfile")
    g6.add_argument("-c", "--coder", default="byte", choices=["byte", "fix", "var"])
    g6.add_argument("-r", "--radix", type=int, default=16,
                    help="accepted for reference compatibility; output is radix-independent")
    g6.add_argument("-o", "--order", default="none",
                    choices=["none", "freq", "greedy", "topo", "bubble"],
                    help="alphabet reorder heuristic (the reference parses -o "
                    "but never applies it; here non-none IS applied and "
                    "produces an extension blob carrying the 256-byte table "
                    "— pass the same -o to -u)")
    g6.add_argument("-u", "--unpack", action="store_true")

    for mode in ("e", "d"):
        gb = sub.add_parser(mode, help="native block-streamed container")
        gb.add_argument("infile")
        gb.add_argument("outfile")
        gb.add_argument("-g", "--generation", default="a4", choices=["a4", "a7"])
        gb.add_argument("-b", "--block-size", type=lambda s: int(s, 0), default=None)
        if mode == "e":
            gb.add_argument(
                "--no-verify",
                action="store_true",
                help="skip the always-on LF certificate",
            )
            gb.add_argument(
                "--resume",
                action="store_true",
                help="continue an interrupted encode: keep complete blocks "
                "already in OUTFILE, truncate any partial frame, encode the rest",
            )
            gb.add_argument(
                "--impl", default="micro",
                choices=["micro", "v3", "stream", "it2"],
                help="device program: cascade-free batched fast path (micro), "
                "in-program batched cascade (v3), per-block streamed 1D "
                "dispatches (stream; verify becomes a full host round-trip "
                "check), or the IT-2 reduced-volume induced path with "
                "automatic v3 fallback (it2)",
            )
            gb.add_argument(
                "--dp", type=int, default=1,
                help="shard the block batch over N devices (data parallel)",
            )
            gb.add_argument(
                "--pack",
                action="store_true",
                help="entropy-pack each block (MTF+RLE0+Huffman, ATA2 "
                "container) — the compressing output format; decode "
                "auto-detects it",
            )
            gb.add_argument(
                "--sp", type=int, default=1,
                help="encode as ONE megablock text-sharded over N devices "
                "(sharded SA -> BWT -> entropy pipeline; ATM1 container)",
            )

    args = p.parse_args(argv)
    cfg = _config_from_args(args)
    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    import functools

    _rw = functools.partial(_rw_timed, profile_dir=cfg.profile_dir)

    if args.cmd in ("a4", "a7"):
        from . import formats

        if args.mode == "e":
            _rw(args, lambda d: formats.encode(d, cfg.generation, verify=cfg.verify))
        else:
            _rw(args, lambda d: formats.decode(d, cfg.generation, device=not cfg.use_native))
    elif args.cmd == "a6":
        from .core import a6 as core_a6

        if args.unpack:
            _rw(args, lambda d: core_a6.a6_decode(d, cfg.coder, order=cfg.order))
        else:
            _rw(args, lambda d: core_a6.a6_encode(d, cfg.coder, order=cfg.order))
    else:
        from .io import blocks

        if args.cmd == "e":
            if cfg.sp > 1:
                import jax

                from .parallel.blocks import make_mesh
                from .parallel import megapipe

                mesh = make_mesh({"sp": cfg.sp}, devices=jax.devices()[: cfg.sp])
                _rw(
                    args,
                    lambda d: megapipe.encode_megablock(d, mesh, cfg.generation),
                )
            elif cfg.resume:
                # checkpoint/resume path: complete frames already in OUTFILE
                # are kept, a trailing partial frame is truncated, and only
                # the missing blocks are recomputed (encode_to_path)
                with open(args.infile, "rb") as f:
                    d = f.read()
                t0 = time.perf_counter()
                n_done = blocks.encode_to_path(
                    d, args.outfile, cfg.generation, cfg.block_size,
                    resume=True, verify=cfg.verify, impl=cfg.impl,
                    pack=cfg.pack,
                )
                dt = time.perf_counter() - t0
                import os as _os

                print(
                    f"{len(d)} -> {_os.path.getsize(args.outfile)} bytes "
                    f"({n_done} block(s) recomputed, {dt:.3f} s)"
                )
            else:
                _rw(
                    args,
                    lambda d: blocks.encode_file(
                        d, cfg.generation, cfg.block_size, verify=cfg.verify,
                        impl=cfg.impl, dp=cfg.dp, pack=cfg.pack,
                    ),
                )
        else:
            def _decode_any(d):
                from .parallel import megapipe

                if d[:4] == megapipe.MAGIC:  # sharded megablock container
                    return megapipe.decode_megablock(d)
                return blocks.decode_file(d)

            _rw(args, _decode_any)
    return 0


def _config_from_args(args) -> "ArchonConfig":
    """Collect the parsed flags into the single ArchonConfig the pipelines
    consume (SURVEY.md section 5: one dataclass config, reference switch names)."""
    from .config import ArchonConfig
    from .io.blocks import DEFAULT_BLOCK

    import os

    cfg = ArchonConfig()
    cfg.generation = getattr(args, "generation", None) or (
        args.cmd if args.cmd in ("a4", "a6", "a7") else "a4"
    )
    cfg.verify = not getattr(args, "no_verify", False)
    cfg.block_size = getattr(args, "block_size", None) or DEFAULT_BLOCK
    cfg.coder = getattr(args, "coder", cfg.coder)
    cfg.order = getattr(args, "order", cfg.order)
    cfg.radix = getattr(args, "radix", cfg.radix)
    cfg.impl = getattr(args, "impl", cfg.impl)
    cfg.dp = getattr(args, "dp", cfg.dp)
    cfg.sp = getattr(args, "sp", cfg.sp)
    cfg.resume = getattr(args, "resume", cfg.resume)
    cfg.pack = getattr(args, "pack", getattr(cfg, "pack", False))
    cfg.profile_dir = (
        getattr(args, "profile_dir", None) or os.environ.get("ARCHON_PROFILE_DIR")
    )
    return cfg


if __name__ == "__main__":
    sys.exit(main())
