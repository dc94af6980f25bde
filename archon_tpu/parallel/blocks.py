"""Block-parallel (DP) BWT pipeline over a device mesh.

The reference's scaling unit is the independent block (final/x1 fixed 4 MB
blocks, ArchonX1.c:53-60; x2/x3 configurable ``-b``).  Here blocks become a
leading array axis sharded over the ``dp`` mesh axis; XLA SPMD partitions the
whole batched transform with zero cross-device communication — the mesh
equivalent of the reference's block streaming loop.  The mesh is a plain
reshape of the device list: the dp path has no collectives, and the sp
path's all_to_all/ppermute traffic sees every device pair alike.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.batched import (
    bwt_batched_micro,
    bwt_batched_micro_certified,
    bwt_batched_v3,
    bwt_batched_v3_certified,
)
from ..core.unbwt import bwt_inverse
from ..core.doubling import SENT_SMALL


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh; default 1D 'dp' over all local devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if axes is None:
        axes = {"dp": devices.size}
    shape = tuple(axes.values())
    return Mesh(devices.reshape(shape), tuple(axes.keys()))


@functools.partial(jax.jit, static_argnames=("sentinel",))
def _bwt_blocks(blocks: jnp.ndarray, sentinel: str):
    # hand-batched v3 (lockstep scalar k): row-wise ops partition cleanly
    # along the dp-sharded block axis under SPMD, and beat a vmap of the 1D
    # path (which would lift the shared dynamic-slice shifts into gathers)
    return bwt_batched_v3(blocks, sentinel)


@functools.partial(jax.jit, static_argnames=("sentinel",))
def _bwt_blocks_certified(blocks: jnp.ndarray, sentinel: str):
    return bwt_batched_v3_certified(blocks, sentinel)


@functools.partial(jax.jit, static_argnames=("sentinel",))
def _unbwt_blocks(L: jnp.ndarray, base: jnp.ndarray, sentinel: str):
    return jax.vmap(lambda l, b: bwt_inverse(l, b, sentinel))(L, base)


def bwt_blocks(blocks, sentinel: str = SENT_SMALL, mesh: Mesh | None = None):
    """Forward-BWT a (num_blocks, block_len) uint8 array, dp-sharded."""
    if mesh is not None:
        spec = NamedSharding(mesh, P("dp"))
        blocks = jax.device_put(blocks, spec)
    return _bwt_blocks(blocks, sentinel)


def bwt_blocks_certified(blocks, sentinel: str = SENT_SMALL, mesh: Mesh | None = None):
    """Forward-BWT with the always-on per-block LF certificate: returns
    (L2, base2, ok2) — the dp-sharded production path with verification
    compiled in, like the reference's VERIFY builds (a4/src/main.c:7)."""
    if mesh is not None:
        spec = NamedSharding(mesh, P("dp"))
        blocks = jax.device_put(blocks, spec)
    return _bwt_blocks_certified(blocks, sentinel)


def bwt_blocks_micro(blocks, sentinel: str = SENT_SMALL, mesh: Mesh | None = None):
    """Fast-path forward BWT (no cascade in the graph): (L2, base2, resolved2).
    Rows with resolved2=False must be recomputed by the caller — see
    core.batched.bwt_batched_micro."""
    if mesh is not None:
        blocks = jax.device_put(blocks, NamedSharding(mesh, P("dp")))
    return bwt_batched_micro(blocks, sentinel)


def bwt_blocks_micro_certified(
    blocks, sentinel: str = SENT_SMALL, mesh: Mesh | None = None
):
    """Fast-path forward BWT with the per-block LF certificate:
    (L2, base2, ok2, resolved2)."""
    if mesh is not None:
        blocks = jax.device_put(blocks, NamedSharding(mesh, P("dp")))
    return bwt_batched_micro_certified(blocks, sentinel)


def unbwt_blocks(L, base, sentinel: str = SENT_SMALL, mesh: Mesh | None = None):
    """Inverse-BWT a batch of (L, base) blocks, dp-sharded."""
    if mesh is not None:
        L = jax.device_put(L, NamedSharding(mesh, P("dp")))
        base = jax.device_put(base, NamedSharding(mesh, P("dp")))
    return _unbwt_blocks(L, base, sentinel)
