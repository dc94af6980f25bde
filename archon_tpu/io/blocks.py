"""Block-streaming container format — the production path.

The reference streams fixed blocks with per-block self-contained framing
(final/x1/ArchonX1.c:53-60: [n][payload][baza] per 4 MB block;
final/x2/ArchonX2.c:50-53,87-99 adds a {sig, block_size} file header and a
``-b`` option).  That per-block framing is the scaling and recovery unit
(SURVEY.md section 5: checkpoint/resume): each block transforms and inverts
independently, so blocks shard trivially across chips/hosts (parallel/blocks)
and a failed block re-dispatches without touching the rest.

Our container keeps the same shape with an explicit version + convention:

    header: magic b'ATA1' | u8 generation (0=a4-small, 1=a7-large)
            | u8 flags | u16 reserved | u32 block_size
    block : u32 n | n payload bytes | u32 base

The per-block payload/base are byte-identical with the corresponding
single-block reference format (a4/a7), so any block can be extracted and fed
to the reference decoder.  The x1/x2/x3 *sort semantics* are intentionally
not reproduced: their anchor/LSC defenses are subsumed by the doubling core
(SURVEY.md "what NOT to port"), and x1 cannot even decode its own output
(it ships no decoder).
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"ATA1"
MAGIC_PACKED = b"ATA2"  # per-block MTF+RLE0+Huffman payloads (entropy/pack)
GENERATIONS = {"a4": 0, "a7": 1}
GEN_NAMES = {v: k for k, v in GENERATIONS.items()}
DEFAULT_BLOCK = 1 << 22  # 4 MiB, the x1 historical default (ArchonX1.c:19)
FLAG_PACKED = 1


def _fallback_row(row: np.ndarray, sentinel: str, verify: bool):
    """Recompute one block through the 1D cascade path (core.fast2.bwt_v3
    territory) — the rare-residue escape hatch for rows the fast batched
    program could not resolve (pathological >4096-active or >16k-deep ties,
    e.g. Gauntlet-class periodicity)."""
    import jax.numpy as jnp

    from ..core.batched import verify_bwt_batched
    from ..core.fast2 import bwt_forward_v2

    arr = jnp.asarray(row)
    L, base, rank = bwt_forward_v2(arr, sentinel)
    if verify:
        ok = verify_bwt_batched(
            arr[None], rank[None], L[None], base[None], sentinel
        )
        if not bool(np.asarray(ok)[0]):
            raise AssertionError(
                "BWT verification failed on fallback block (internal error)"
            )
    return np.asarray(L), int(base)


# Dispatch-unit size (blocks) for the encode pipeline: equal-length runs are
# split into chunks of this many rows, and chunk i+1 is DISPATCHED before
# chunk i's payload is fetched — the device computes the next chunk while the
# host drains the previous one's L over the device->host path (a serial
# compute-then-fetch loop leaves the device idle during every fetch).  The
# reference streams blocks strictly serially (final/x1/ArchonX1.c:53-60).
PIPE_BLOCKS = 8


def _streamed_forward(blocks: list[bytes], generation: str, verify: bool,
                      use_it2: bool = False):
    """Per-block 1D dispatch stream (``impl="stream"``): each block runs the
    whole-file v3 pipeline (core/fast2.bwt_v3 — exact for every input, its
    narrowed cascade and micro tail included, so NO fallback rows exist)
    and blocks are dispatched back-to-back so XLA pipelines them.

    Motivation: the lockstep-batched rows all pay the batch's maximum
    round count and the shape-invariant tail together; streamed blocks
    each pay only their own.

    ``verify=True`` performs a FULL host-native round-trip per block
    (native.unbwt(L, base) == block) on a thread pool — strictly stronger
    than the LF certificate.

    Dispatch is WINDOWED: at most PIPE_BLOCKS blocks are in flight before
    the oldest one's payload is fetched, so the device-resident footprint
    is O(window * block), not O(file) — the same double-buffering
    discipline the batched path applies per dispatch unit.  The window is
    deep enough that XLA still pipelines the independent programs through
    the device queue."""
    from collections import deque

    from ..core.doubling import SENT_SMALL, SENT_LARGE
    from ..core.fast2 import bwt_v3
    import jax.numpy as jnp

    sentinel = SENT_SMALL if generation == "a4" else SENT_LARGE
    window = int(os.environ.get("ARCHON_PIPE_BLOCKS", PIPE_BLOCKS)) or len(blocks)

    if use_it2:
        # IT-2 reduced-volume candidate (core/it2): dispatch the SYNC-FREE
        # async form per block (the residual na fetch would otherwise
        # serialize every dispatch behind a host round trip); a block
        # whose static caps can't resolve exactly flags ok=False at
        # finish time and is recomputed through bwt_v3 — the same
        # candidate + exact-check + fallback discipline verify=True
        # applies end-to-end anyway.
        from ..core.it2 import bwt_it2_async

        def dispatch_block(arr):
            return bwt_it2_async(arr, sentinel)

        def fetch_result(arr, out):
            L, base, ok = out()
            if bool(ok):
                return np.asarray(L), int(base)
            L, base = bwt_v3(arr, sentinel)
            return np.asarray(L), int(base)
    else:
        def dispatch_block(arr):
            return bwt_v3(arr, sentinel)

        def fetch_result(arr, out):
            L, base = out
            return np.asarray(L), int(base)

    from .. import native

    use_native = native.available() and verify

    def fetch(h):
        if h is None:
            return (np.zeros(0, np.uint8), 0, None)
        orig, arr, out = h
        L, base = fetch_result(arr, out)
        return (L, base, orig)

    fetched = []
    pending = deque()  # (original_block_bytes, device input, device result) | None
    for b in blocks:
        if len(b) == 0:
            pending.append(None)
        else:
            arr = jnp.asarray(np.frombuffer(b[::-1], np.uint8))
            pending.append((b, arr, dispatch_block(arr)))
        if len(pending) > window:
            fetched.append(fetch(pending.popleft()))
    while pending:
        fetched.append(fetch(pending.popleft()))

    if verify:
        # the LF walk of the format's (L, base) yields the block in its
        # ORIGINAL orientation (the reversal is part of the format
        # convention — same walk decode_file runs)
        def check(item):
            idx, (L, base, orig) = item
            if orig is None:
                return True
            if use_native:
                return native.unbwt(L, base, sentinel == SENT_LARGE).tobytes() == orig
            from ..golden.sa import bwt_inverse

            return bwt_inverse(L, base, sentinel).tobytes() == orig

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(len(fetched), os.cpu_count() or 1)) as ex:
            oks = list(ex.map(check, enumerate(fetched)))
        bad = [i for i, ok in enumerate(oks) if not ok]
        if bad:
            raise AssertionError(
                f"round-trip verification failed for block(s) {bad} (internal error)"
            )
    return [(L, base) for (L, base, _rev) in fetched]


def _batched_forward(blocks: list[bytes], generation: str, verify: bool = True,
                     impl: str = "micro", mesh=None):
    """Transform blocks, batching equal-length runs through the dp pipeline.

    ``verify=True`` (default) runs the per-block LF certificate on device —
    the production container keeps verification always-on exactly like the
    reference binaries do (a4/src/main.c:7 VERIFY; a6/src/bwt.c:19-23).

    The device program is the cascade-free fast path by default
    (``impl="micro"``, core.batched.bwt_batched_micro*): rows it reports
    unresolved — real text never does — are recomputed through the 1D
    cascade pipeline.  ``impl="v3"`` selects the in-program cascade variant
    (no host fallback).  ``mesh`` dp-shards the block batch over devices.

    Equal-length runs are chunked into PIPE_BLOCKS-row dispatch units and
    double-buffered: unit i+1 is dispatched (async) before unit i's payload
    is fetched, overlapping device compute with the device->host transfer."""
    from ..core.doubling import SENT_SMALL, SENT_LARGE
    from ..parallel.blocks import (
        bwt_blocks,
        bwt_blocks_certified,
        bwt_blocks_micro,
        bwt_blocks_micro_certified,
    )
    import jax.numpy as jnp

    if impl == "stream":
        return _streamed_forward(blocks, generation, verify)
    if impl == "it2":
        return _streamed_forward(blocks, generation, verify, use_it2=True)
    if impl not in ("micro", "v3"):
        raise ValueError(f"unknown impl {impl!r}")
    sentinel = SENT_SMALL if generation == "a4" else SENT_LARGE
    pipe = int(os.environ.get("ARCHON_PIPE_BLOCKS", PIPE_BLOCKS)) or len(blocks)
    if mesh is not None:
        # a dispatch unit must stay shardable over the dp mesh
        pipe = -(-pipe // mesh.size) * mesh.size

    # split into dispatch units: equal-length runs, chunked to `pipe` rows
    units = []  # (first_index, [block bytes...]); empty blocks pass through
    i = 0
    while i < len(blocks):
        if len(blocks[i]) == 0:
            units.append((i, None))
            i += 1
            continue
        j = i
        while j < len(blocks) and len(blocks[j]) == len(blocks[i]):
            j += 1
        for s in range(i, j, pipe):
            units.append((s, blocks[s : min(s + pipe, j)]))
        i = j

    def dispatch(unit):
        first, blks = unit
        if blks is None:
            return ()
        batch = np.stack([np.frombuffer(b[::-1], np.uint8) for b in blks])
        ones = np.ones(len(blks), bool)
        # a ragged tail batch (fewer rows than devices) runs unsharded
        m = mesh if mesh is not None and len(blks) % mesh.size == 0 else None
        if impl == "v3":
            if verify:
                L, base, ok = bwt_blocks_certified(
                    jnp.asarray(batch), sentinel, mesh=m
                )
            else:
                (L, base), ok = bwt_blocks(jnp.asarray(batch), sentinel, mesh=m), ones
            resolved = ones
        elif verify:
            L, base, ok, resolved = bwt_blocks_micro_certified(
                jnp.asarray(batch), sentinel, mesh=m
            )
        else:
            L, base, resolved = bwt_blocks_micro(
                jnp.asarray(batch), sentinel, mesh=m
            )
            ok = resolved
        return first, batch, L, base, ok, resolved

    def collect(handle):
        if handle == ():
            return [(np.zeros(0, np.uint8), 0)]
        first, batch, L, base, ok, resolved = handle
        resolved = np.asarray(resolved)
        ok = np.asarray(ok)
        if verify and not (ok | ~resolved).all():
            bad = [first + t for t in np.nonzero(~ok & resolved)[0].tolist()]
            raise AssertionError(
                f"BWT verification failed for block(s) {bad} (internal error)"
            )
        L = np.asarray(L)
        base = np.asarray(base)
        got = []
        for t in range(len(batch)):
            if resolved[t]:
                got.append((L[t], int(base[t])))
            else:
                got.append(_fallback_row(batch[t], sentinel, verify))
        return got

    out = []
    prev = None
    for unit in units:
        cur = dispatch(unit)  # async: enqueued before prev's payload fetch
        if prev is not None:
            out.extend(collect(prev))
        prev = cur
    if prev is not None:
        out.extend(collect(prev))
    return out


def _pack_payloads(results: list) -> list[bytes]:
    """Entropy-pack each block's L on the host thread pool (the native
    MTF/RLE0/bitpack calls release the GIL, so blocks pack on all cores —
    the encode-side analog of the pooled native decode)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..entropy.pack import pack_block

    items = [L for (L, _base) in results]
    if len(items) > 1:
        with ThreadPoolExecutor(
            max_workers=min(len(items), os.cpu_count() or 1)
        ) as ex:
            return list(ex.map(pack_block, items))
    return [pack_block(L) for L in items]


def encode_file(
    data: bytes,
    generation: str = "a4",
    block_size: int = DEFAULT_BLOCK,
    verify: bool = True,
    impl: str = "micro",
    dp: int = 1,
    pack: bool = False,
) -> bytes:
    """Encode into the blocked container.  ``impl`` selects the device
    program (micro = cascade-free batched fast path, v3 = in-program
    batched cascade, stream = per-block 1D dispatch stream — see
    ``_streamed_forward``); ``dp > 1`` shards the block batch over a
    dp-axis device mesh (parallel/blocks.py; ignored by stream, whose
    blocks pipeline through one device's queue).

    ``pack=True`` writes the COMPRESSING container (ATA2): each block's
    payload is MTF+RLE0+Huffman-packed (entropy/pack.py) — the bzip-class
    back end the reference family names as its ratio goal but never ships
    (README.md:17).  Frame: u32 n | u32 plen | payload | u32 base."""
    if generation not in GENERATIONS:
        raise ValueError(f"unknown generation {generation!r}")
    mesh = None
    if dp > 1:
        import jax

        from ..parallel.blocks import make_mesh

        mesh = make_mesh({"dp": dp}, devices=jax.devices()[:dp])
    header = (MAGIC_PACKED if pack else MAGIC) + struct.pack(
        "<BBHI", GENERATIONS[generation], FLAG_PACKED if pack else 0, 0,
        block_size,
    )
    blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)] or [b""]
    results = _batched_forward(blocks, generation, verify, impl, mesh)
    chunks = [header]
    if pack:
        payloads = _pack_payloads(results)
        for (L, base), blk, payload in zip(results, blocks, payloads):
            chunks.append(struct.pack("<II", len(blk), len(payload)))
            chunks.append(payload)
            chunks.append(struct.pack("<I", base))
    else:
        for (L, base), blk in zip(results, blocks):
            chunks.append(struct.pack("<I", len(blk)))
            chunks.append(L.tobytes())
            chunks.append(struct.pack("<I", base))
    return b"".join(chunks)


def _scan_complete_blocks(path, generation: str, block_size: int,
                          expect_lens=None):
    """Number of COMPLETE frames in a (possibly truncated) container at
    ``path``, the byte offset just past the last complete frame, and the
    offset of that last frame's header.  Returns None if the file is
    missing/invalid or its header disagrees.

    ``expect_lens`` (the current input's block lengths) bounds the scan:
    a frame whose stored n disagrees with the input's block length — the
    input changed since the partial encode — stops the scan at the last
    still-consistent frame, so stale frames beyond a SHRUNK input are
    truncated away rather than silently kept."""
    import os

    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    if size < 12:
        return None
    with open(path, "rb") as f:
        head = f.read(12)
        packed = head[:4] == MAGIC_PACKED
        if head[:4] != MAGIC and not packed:
            return None
        gen_id, _flags, _rsvd, bs = struct.unpack("<BBHI", head[4:12])
        if gen_id != GENERATIONS[generation] or bs != block_size:
            return None
        pos, count, last = 12, 0, 12
        while True:
            hdr = f.read(8 if packed else 4)
            if len(hdr) < (8 if packed else 4):
                break
            if packed:
                n, plen = struct.unpack("<II", hdr)
                frame = 12 + plen
            else:
                (n,) = struct.unpack("<I", hdr)
                plen = n
                frame = 8 + n
            if pos + frame > size:
                break
            if expect_lens is not None and (
                count >= len(expect_lens) or n != expect_lens[count]
            ):
                break
            f.seek(plen + 4, 1)
            last = pos
            pos += frame
            count += 1
    return count, pos, last, packed


def _last_frame_matches(path, frame_start: int, frame_end: int,
                        generation: str, block: bytes,
                        packed: bool = False) -> bool:
    """Round-trip the frame at [frame_start, frame_end) against ``block``:
    the input-drift guard for --resume.  A partial encode whose INPUT
    changed since (same lengths, different bytes) would otherwise keep
    stale frames that silently decode to wrong data; decoding the last
    kept frame and byte-comparing catches the drift at the resume point.
    Cost: one block decode on the native walk."""
    from ..core.doubling import SENT_LARGE, SENT_SMALL
    from .. import native

    with open(path, "rb") as f:
        f.seek(frame_start)
        raw = f.read(frame_end - frame_start)
    if packed:
        if len(raw) < 12:
            return False
        n, plen = struct.unpack("<II", raw[:8])
        if n != len(block) or len(raw) != plen + 12:
            return False
        try:
            from ..entropy.pack import unpack_block

            L = unpack_block(raw[8 : 8 + plen], n)
        except ValueError:
            return False
        (base,) = struct.unpack("<I", raw[8 + plen :])
        if n == 0:
            return len(block) == 0
        if base >= n:
            return False
        sentinel_large = generation != "a4"
        try:
            return native.unbwt(L, base, sentinel_large).tobytes() == block
        except ValueError:
            return False
    (n,) = struct.unpack("<I", raw[:4])
    if n != len(block) or len(raw) != n + 8:
        return False
    L = np.frombuffer(raw[4 : 4 + n], np.uint8)
    (base,) = struct.unpack("<I", raw[4 + n :])
    if n == 0:
        return len(block) == 0
    if base >= n:
        return False
    sentinel_large = generation != "a4"
    try:
        if native.available():
            out = native.unbwt(L, base, sentinel_large).tobytes()
        else:
            from ..golden.sa import bwt_inverse

            out = bwt_inverse(
                L, base, SENT_LARGE if sentinel_large else SENT_SMALL
            ).tobytes()
    except ValueError:
        return False
    return out == block


def encode_to_path(
    data: bytes,
    path,
    generation: str = "a4",
    block_size: int = DEFAULT_BLOCK,
    resume: bool = False,
    flush_blocks: int = 16,
    verify: bool = True,
    impl: str = "micro",
    pack: bool = False,
) -> int:
    """Streaming encode with checkpoint/resume at block granularity.

    Frames are appended and flushed every ``flush_blocks`` blocks, so the
    on-disk prefix is always a valid container of complete blocks — the
    self-contained per-block framing the reference streams (x1:
    [n|payload|baza] per block, ArchonX1.c:55-56,131) made into an actual
    recovery point (SURVEY.md section 5: the reference has NO
    checkpoint/resume; its framing is merely the implied unit).  With
    ``resume=True`` an interrupted output is scanned, any trailing partial
    frame is truncated away, and encoding continues from the first
    missing block.  Returns the number of blocks (re)computed."""
    if generation not in GENERATIONS:
        raise ValueError(f"unknown generation {generation!r}")
    blocks = [
        data[i : i + block_size] for i in range(0, len(data), block_size)
    ] or [b""]
    done = 0
    state = (
        _scan_complete_blocks(
            path, generation, block_size, [len(b) for b in blocks]
        )
        if resume
        else None
    )
    if state is not None:
        done, keep, last, was_packed = state
        if was_packed != pack:
            state, done = None, 0  # container kind changed — restart
        elif done > 0 and not _last_frame_matches(
            path, last, keep, generation, blocks[done - 1], packed=pack
        ):
            # input drifted since the partial encode: stale frames would
            # silently decode to the OLD data — restart from scratch
            state, done = None, 0
    if state is not None:
        with open(path, "r+b") as f:
            f.truncate(keep)
        mode = "ab"
    else:
        mode = "wb"
    computed = 0
    with open(path, mode) as f:
        if mode == "wb":
            f.write(
                (MAGIC_PACKED if pack else MAGIC)
                + struct.pack(
                    "<BBHI", GENERATIONS[generation],
                    FLAG_PACKED if pack else 0, 0, block_size,
                )
            )
        todo = blocks[done:]
        for i in range(0, len(todo), flush_blocks):
            batch = todo[i : i + flush_blocks]
            results = _batched_forward(batch, generation, verify, impl)
            payloads = _pack_payloads(results) if pack else None
            for t, ((L, base), blk) in enumerate(zip(results, batch)):
                if pack:
                    f.write(struct.pack("<II", len(blk), len(payloads[t])))
                    f.write(payloads[t])
                else:
                    f.write(struct.pack("<I", len(blk)))
                    f.write(L.tobytes())
                f.write(struct.pack("<I", base))
                computed += 1
            f.flush()
    return computed


def decode_file(blob: bytes, strict: bool = True, on_error=None) -> bytes:
    """Invert a container.  ``strict=False`` gives per-block fault isolation
    (the recovery granularity SURVEY.md section 5 calls for): a corrupt block
    — LF walk not a single cycle — is replaced by zero bytes and reported via
    ``on_error(block_index, exception)`` instead of poisoning the whole file;
    every other block decodes normally and can be re-dispatched.
    """
    return _decode_file(blob, strict, on_error)


def _decode_file(blob: bytes, strict: bool = True, on_error=None) -> bytes:
    from ..core.doubling import SENT_SMALL, SENT_LARGE
    from ..core.unbwt import bwt_inverse
    import jax.numpy as jnp

    packed = blob[:4] == MAGIC_PACKED
    if blob[:4] != MAGIC and not packed:
        raise ValueError("bad magic")
    gen_id, _flags, _rsvd, block_size = struct.unpack("<BBHI", blob[4:12])
    sentinel = SENT_SMALL if gen_id == 0 else SENT_LARGE
    from .. import native

    use_native = native.available()

    # parse framing first so blocks can decode in parallel
    parsed = []  # (idx, L-or-packed-payload, base, n)
    pos = 12
    idx = 0
    while pos < len(blob):
        if packed:
            n, plen = struct.unpack("<II", blob[pos : pos + 8])
            pos += 8
            payload = blob[pos : pos + plen]
            pos += plen
        else:
            (n,) = struct.unpack("<I", blob[pos : pos + 4])
            pos += 4
            payload = np.frombuffer(blob[pos : pos + n], np.uint8)
            pos += n
        (base,) = struct.unpack("<I", blob[pos : pos + 4])
        pos += 4
        parsed.append((idx, payload, base, n))
        idx += 1

    def decode_one(item):
        idx, L, base, n = item
        if not n:
            return b""
        try:
            if packed:
                from ..entropy.pack import unpack_block

                L = unpack_block(L, n)
            if base >= n:
                raise ValueError(f"block {idx}: base {base} out of range")
            if not strict and use_native and not native.verify_cycle(
                L, base, sentinel == SENT_LARGE
            ):
                raise ValueError(f"block {idx}: LF walk is not a single cycle")
            if use_native:
                return native.unbwt(L, base, sentinel == SENT_LARGE).tobytes()
            rt = bwt_inverse(jnp.asarray(L), jnp.int32(base), sentinel)
            return np.asarray(rt).tobytes()
        except ValueError as e:
            if strict:
                raise
            if on_error is not None:
                on_error(idx, e)
            return b"\x00" * n

    if use_native and len(parsed) > 1:
        # the native LF walk releases the GIL (plain ctypes call), so
        # independent blocks decode on all cores — the decode-side analog
        # of the dp-sharded forward pipeline
        import os
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(parsed), os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            out = list(ex.map(decode_one, parsed))
    else:
        out = [decode_one(it) for it in parsed]
    return b"".join(out)


def extract_block(blob: bytes, index: int) -> bytes:
    """Extract block #index as a standalone reference-format blob
    (payload + trailing u32 base — decodable by the reference binary).
    Packed (ATA2) frames are entropy-unpacked first, so any block of
    either container feeds the reference decoder unchanged."""
    packed = blob[:4] == MAGIC_PACKED
    if blob[:4] != MAGIC and not packed:
        raise ValueError("bad magic")
    pos = 12
    i = 0
    while pos < len(blob):
        if packed:
            n, plen = struct.unpack("<II", blob[pos : pos + 8])
            if i == index:
                from ..entropy.pack import unpack_block

                L = unpack_block(blob[pos + 8 : pos + 8 + plen], n)
                return L.tobytes() + blob[pos + 8 + plen : pos + 12 + plen]
            pos += 12 + plen
        else:
            (n,) = struct.unpack("<I", blob[pos : pos + 4])
            if i == index:
                return blob[pos + 4 : pos + 8 + n]
            pos += 8 + n
        i += 1
    raise IndexError(index)
