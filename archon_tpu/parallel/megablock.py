"""Sharded-megablock suffix sort: distributed prefix doubling over a mesh.

For inputs too large for one chip, the text shards across the ``sp`` mesh
axis and each doubling round runs as a distributed sort (SURVEY.md section 7
layer 8b; the rank-merge scale-out of BASELINE config 5).  Per round
(context k, quadrupling — the tuple (r@0, r@k, r@2k, r@3k) covers 4k):

1. shifted ranks r@jk arrive by a *bounded halo*: for static k the window
   ``rank[pos + j*k : pos + j*k + S]`` is two static slices of two ring
   neighbors at distance ``(j*k)//S`` — exactly S values per window travel
   by ppermute (the round-1 full ``all_gather`` is gone; per-shard memory
   is O(S), never O(n));
2. tuples (r0, r1, r2, r3, pos) — ``pos`` makes the key total — are sorted
   globally by a **bitonic merge-split network over shards**: local sort,
   then log2(ns)*(log2(ns)+1)/2 ppermute+merge stages.  By the merge-split
   replacement principle (any sorting network sorts blocks when
   compare-exchange becomes merge-split of sorted blocks) the result is the
   exact global order with *exactly S tuples per shard*: no splitter
   sampling, no per-destination capacity, and therefore no overflow aborts —
   a tie group spanning every shard (all-zeros input) is handled by
   construction, restoring the repetition-immunity the single-chip doubling
   core is built on (core/doubling.py);
3. head flags compare neighbor tuples (boundary tuple by ppermute); the
   group-head slot propagates across any number of headless shards via an
   all_gather of ns per-shard scalars + running max;
4. (pos, new_rank) pairs return to pos-owner shards by a second (2-wide)
   merge-split network — the route-back is a permutation, and the same
   theorem gives exact balance with zero capacity assumptions.

Termination runs *dispatch-ahead*: round k+1 is enqueued before round k's
surviving-tie count is fetched, so the host sync overlaps device execution
(at most one wasted round).  Rounds are compiled per static k (the halo
ring distances must be static for ppermute); builders are cached.

Scale notes: each merge-split stage re-sorts 2S elements per shard, so
the network is expected to be compute-bound (the re-sorts), not
wire-bound; lax.ragged_all_to_all is the O(stages)->O(1) stage-compute
upgrade (it is UNIMPLEMENTED on XLA:CPU, so this portable network, which
the tests run on a CPU mesh, stays the default).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:  # jax >= 0.8 top-level API; experimental path kept for older jax
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..core.doubling import SENT_LARGE, SENT_SMALL

AXIS = "sp"


def _pairs(ns: int, m: int):
    """ppermute spec exchanging with the partner at xor-distance m."""
    return [(i, i ^ m) for i in range(ns)]


def _rot(ns: int, d: int):
    """ppermute spec: receiver i gets data from shard (i + d) % ns."""
    return [(s, (s - d) % ns) for s in range(ns)]


def _bitonic_stages(ns: int):
    """(k_bit, m) per merge-split stage of Batcher's bitonic network."""
    stages = []
    size = 2
    while size <= ns:
        m = size // 2
        while m >= 1:
            stages.append((size, m))
            m //= 2
        size *= 2
    return stages


def _merge_split_sort(arrays, num_keys: int, ns: int, sid):
    """Globally sort shard-distributed arrays by the first num_keys operands.

    Each shard's slice is sorted locally, then Batcher's bitonic network runs
    over shards with merge-split comparators.  Keys must be totally ordering
    (include a unique tie-break operand among the keys).  Returns arrays in
    global sorted order: shard i holds global slots [i*S, (i+1)*S).
    """
    arrays = list(lax.sort(tuple(arrays), num_keys=num_keys))
    S = arrays[0].shape[0]
    for k_bit, m in _bitonic_stages(ns):
        perm = _pairs(ns, m)
        partner = [lax.ppermute(a, AXIS, perm) for a in arrays]
        both = [jnp.concatenate([a, b]) for a, b in zip(arrays, partner)]
        merged = lax.sort(tuple(both), num_keys=num_keys)
        # min half goes to the lower shard of the pair in an ascending
        # region ((sid & k_bit) == 0), to the higher shard otherwise
        keep_low = ((sid & m) == 0) == ((sid & k_bit) == 0)
        arrays = [jnp.where(keep_low, mg[:S], mg[S:]) for mg in merged]
    return arrays


def _halo_window(rank_shard, jk: int, S: int, ns: int):
    """Global rank[sid*S + jk : sid*S + jk + S] via at most two ppermutes.

    Values at global positions >= n are garbage; the caller masks them.
    """
    d, o = divmod(jk, S)
    d %= ns  # ring arithmetic; off-end positions are masked by the caller

    def fetch(x, dist):  # distance-0 needs no wire
        return x if dist == 0 else lax.ppermute(x, AXIS, _rot(ns, dist))

    if o == 0:
        return fetch(rank_shard, d)
    a = fetch(rank_shard[o:], d)
    b = fetch(rank_shard[:o], (d + 1) % ns)
    return jnp.concatenate([a, b])


def _slot_ranks(keys, pos, S: int, ns: int, n: int, sid):
    """Shared back half of init and rounds: global sort of (keys..., pos),
    head flags, group-head slot ranks with cross-shard propagation, active
    count, and the merge-split route-back to pos order.

    Returns (new_rank_shard, nactive)."""
    width = len(keys)
    srt = _merge_split_sort(list(keys) + [pos], width + 1, ns, sid)
    keys_s, pos_s = srt[:width], srt[width]
    iota = lax.iota(jnp.int32, S)
    g_slot = sid * S + iota

    # head flags: tuple differs from predecessor (previous shard's last
    # tuple crosses by ppermute; shard 0 slot 0 is always a head)
    last = jnp.stack([k[-1] for k in keys_s])
    prev = lax.ppermute(last, AXIS, _rot(ns, -1))
    cur = jnp.stack(keys_s)
    before = jnp.concatenate([prev[:, None], cur[:, :-1]], axis=1)
    head = jnp.any(cur != before, axis=0)
    head = head.at[0].set(jnp.where(sid == 0, True, head[0]))

    # rank := slot of the group head.  local cummax, then an exact carry:
    # every shard's last head-slot is all_gathered (ns scalars) and the
    # running max over preceding shards propagates across any number of
    # headless shards in one step.
    local_head = lax.cummax(jnp.where(head, g_slot, -1))
    lasts = lax.all_gather(local_head[-1], AXIS)
    carry = jnp.max(
        jnp.where(lax.iota(jnp.int32, ns) < sid, lasts, -1)
    )
    new_rank_s = jnp.maximum(local_head, carry)

    # surviving ties: group size > 1  <=>  not (head & next-is-head).
    # the successor of the shard's last slot lives on the next shard.
    nbr_first = lax.ppermute(head[:1], AXIS, _rot(ns, 1))
    nxt_head = jnp.concatenate([head[1:], nbr_first])
    nxt_head = nxt_head.at[-1].set(
        jnp.where(sid == ns - 1, True, nxt_head[-1])
    )
    active = jnp.logical_not(head & nxt_head)
    nactive = lax.psum(jnp.sum(active.astype(jnp.int32)), AXIS)

    # route back: (pos_s, rank) is a permutation of [0, n); the 2-wide
    # merge-split network lands pos range [i*S, (i+1)*S) on shard i sorted,
    # so the values column is the pos-ordered rank shard
    _, rank_back = _merge_split_sort([pos_s, new_rank_s], 1, ns, sid)
    return rank_back, nactive


@functools.lru_cache(maxsize=64)
def _make_init(mesh: Mesh, S: int, n: int, sentinel: str):
    """Seed ranks: positional rank of the packed order-3 key at each pos.

    The 2-symbol halo comes from the ring neighbor; ranking runs through the
    shared merge-split machinery (no global-array op anywhere).
    """
    ns = mesh.shape[AXIS]
    pad_val = np.int32(0 if sentinel == SENT_SMALL else 511)

    def init_fn(data_shard):
        sid = lax.axis_index(AXIS)
        ext = data_shard.astype(jnp.int32) + 1
        halo = lax.ppermute(ext[:2], AXIS, _rot(ns, 1))
        halo = jnp.where(sid == ns - 1, jnp.full((2,), pad_val, jnp.int32), halo)
        extp = jnp.concatenate([ext, halo])
        packed = extp[:S] * (512 * 512) + extp[1 : S + 1] * 512 + extp[2 : S + 2]
        pos = sid * S + lax.iota(jnp.int32, S)
        return _slot_ranks((packed,), pos, S, ns, n, sid)

    return jax.jit(
        shard_map(init_fn, mesh=mesh, in_specs=(P(AXIS),), out_specs=(P(AXIS), P()))
    )


@functools.lru_cache(maxsize=256)
def _make_round(mesh: Mesh, S: int, n: int, k: int, sentinel: str):
    """One distributed quadrupling round at static context k (kept for
    comparison/tests; production uses the k-dynamic program below)."""
    ns = mesh.shape[AXIS]
    off_end = np.int32(-1) if sentinel == SENT_SMALL else np.int32(n + 1)

    def round_fn(rank_shard):
        sid = lax.axis_index(AXIS)
        pos = sid * S + lax.iota(jnp.int32, S)

        def shifted(j):
            if j * k >= n:  # whole window off-end (static)
                return jnp.full((S,), off_end, jnp.int32)
            w = _halo_window(rank_shard, j * k, S, ns)
            return jnp.where(pos + j * k < n, w, off_end)

        keys = (rank_shard, shifted(1), shifted(2), shifted(3))
        return _slot_ranks(keys, pos, S, ns, n, sid)

    return jax.jit(
        shard_map(round_fn, mesh=mesh, in_specs=(P(AXIS),), out_specs=(P(AXIS), P()))
    )


def _rotate_dyn(x, d, ns: int):
    """Ring-rotate a shard array by a *traced* distance d in [0, ns): shard i
    ends up holding shard (i+d) % ns's x.  Composition of log2(ns) static
    ppermutes selected by d's bits — the trick that makes ONE compiled round
    program serve every context k (the reference GPU analog: one kernel set,
    jump as a uniform, gpu/Archon.boo:104-118).  Costs log2(ns) hops instead
    of 1, but saves one compile per k value."""
    t = 0
    m = 1
    while m < ns:
        y = lax.ppermute(x, AXIS, _rot(ns, m))
        x = jnp.where((d >> t) & 1 == 1, y, x)
        t += 1
        m <<= 1
    return x


def _halo_window_dyn(rank_shard, jk, S: int, ns: int):
    """Global rank[sid*S + jk : sid*S + jk + S] for traced jk.

    Values at global positions >= n are garbage; the caller masks them."""
    d = (jk // S) % ns
    o = jk % S
    rot_d = _rotate_dyn(rank_shard, d, ns)
    rot_d1 = lax.ppermute(rot_d, AXIS, _rot(ns, 1))
    both = jnp.concatenate([rot_d, rot_d1])
    return lax.dynamic_slice(both, (o,), (S,))


@functools.lru_cache(maxsize=64)
def _make_round_dyn(mesh: Mesh, S: int, n: int, sentinel: str):
    """The k-DYNAMIC distributed quadrupling round: compiled once per
    (mesh, shard size), reused for every context k.  A real 1 GB megablock
    runs ~14 rounds; with per-k programs that would be ~14 compiles before
    the first useful byte — this is one."""
    ns = mesh.shape[AXIS]
    off_end = np.int32(-1) if sentinel == SENT_SMALL else np.int32(n + 1)

    def round_fn(rank_shard, k):
        sid = lax.axis_index(AXIS)
        pos = sid * S + lax.iota(jnp.int32, S)

        def shifted(j):
            jk = j * k
            w = _halo_window_dyn(rank_shard, jk, S, ns)
            return jnp.where(pos + jk < n, w, off_end)

        keys = (rank_shard, shifted(1), shifted(2), shifted(3))
        return _slot_ranks(keys, pos, S, ns, n, sid)

    return jax.jit(
        shard_map(
            round_fn,
            mesh=mesh,
            in_specs=(P(AXIS), P()),
            out_specs=(P(AXIS), P()),
        )
    )


@functools.lru_cache(maxsize=64)
def _make_emit(mesh: Mesh, S: int, n: int):
    """Sharded BWT emission: L[rank[p]] = data[(p-1) mod n], via one more
    merge-split sort keyed on rank with the prev-byte payload riding along —
    the sharded analog of the carried-payload emission in core/batched (and
    of the reference's per-block emit loop, final/x1/ArchonX1.c:118-131;
    GPU gather stage gpu/Archon.boo:336-347).  Shard i returns
    L[i*S:(i+1)*S]; base = rank[0] comes back replicated."""
    ns = mesh.shape[AXIS]

    def emit_fn(rank_shard, data_shard):
        sid = lax.axis_index(AXIS)
        pos = sid * S + lax.iota(jnp.int32, S)
        last = lax.ppermute(data_shard[-1:], AXIS, _rot(ns, -1))
        prev = jnp.concatenate([last, data_shard[:-1]])
        _, L_shard = _merge_split_sort(
            [rank_shard, prev.astype(jnp.int32)], 1, ns, sid
        )
        base = lax.psum(jnp.sum(jnp.where(pos == 0, rank_shard, 0)), AXIS)
        return L_shard.astype(jnp.uint8), base

    return jax.jit(
        shard_map(
            emit_fn,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P()),
        )
    )


def _sharded_ranks(data, mesh: Mesh, sentinel: str):
    """Shared driver: distributed doubling to full rank resolution.
    Returns (rank_device_array, data_device_array, S, n)."""
    arr = np.asarray(data, np.uint8)
    n = len(arr)
    ns = mesh.shape[AXIS]
    if n % ns:
        raise ValueError(f"n={n} not divisible by {ns} shards")
    if ns & (ns - 1):
        raise ValueError(f"shard count {ns} must be a power of two")
    S = n // ns

    data_dev = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P(AXIS)))
    prev_rank, prev_na = _make_init(mesh, S, n, sentinel)(data_dev)

    # dispatch-ahead termination: round k is enqueued BEFORE round k/4's
    # surviving-tie count is fetched, so the host sync overlaps device
    # execution (at most one speculative round runs past resolution)
    round_fn = _make_round_dyn(mesh, S, n, sentinel)
    k = 3
    while k < 4 * n:
        cur = round_fn(prev_rank, jnp.int32(k))
        if int(prev_na) == 0:
            break
        prev_rank, prev_na = cur
        k *= 4
    return prev_rank, data_dev, S, n


def bwt_megablock(data, mesh: Mesh, sentinel: str = SENT_SMALL):
    """Sharded forward BWT of one megablock: returns (L_shards, base) with
    L still device-resident and sharded over 'sp' (shard i holds
    L[i*S:(i+1)*S]) — ready for the sharded entropy stage
    (parallel.megapipe) without ever materializing L on one device."""
    rank, data_dev, S, n = _sharded_ranks(data, mesh, sentinel)
    L, base = _make_emit(mesh, S, n)(rank, data_dev)
    return L, int(base)


def suffix_array_sharded(data, mesh: Mesh, sentinel: str = SENT_SMALL) -> np.ndarray:
    """Distributed suffix array over mesh axis 'sp'.

    Exact for every input (incl. shard-spanning tie groups: all-zeros,
    Fibonacci strings — the Gauntlet pathologies).  ``n`` must divide
    evenly by the shard count (the block container pads); the shard count
    must be a power of two (the bitonic merge-split network needs it).
    """
    prev_rank, _data_dev, S, n = _sharded_ranks(data, mesh, sentinel)
    r = np.asarray(prev_rank)
    if np.unique(r).size != n:  # pragma: no cover - permutation invariant
        raise AssertionError("megablock ranks did not resolve to a permutation")
    sa = np.zeros(n, np.int32)
    sa[r] = np.arange(n, dtype=np.int32)
    return sa
