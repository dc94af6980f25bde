"""Blocked prefix scans.

A backend may lower ``lax.cummax``/``cumsum`` along an axis as a length-n
sequential scan, far above the memory-bandwidth floor, and the suffix
pipeline runs one full-width cummax per sort round.  The blocked form
needs no custom kernel: split the
scan axis into C-length chunks, scan WITHIN chunks (the sequential dimension
shrinks to C while every chunk scans in parallel as a vectorized leading
dim), scan the n/C chunk totals (cheap), and combine.  Three bandwidth-bound
passes instead of an n-step scan.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def blocked_cummax(x: jnp.ndarray, chunk: int = 512) -> jnp.ndarray:
    """Per-row inclusive cummax along the last axis, two-level blocked.

    Exact for any input (associative+idempotent combine); falls back to
    ``lax.cummax`` when the axis is short or does not divide ``chunk``
    (callers in the suffix pipeline always pass power-of-two widths).
    """
    n = x.shape[-1]
    if n <= chunk * 2 or n % chunk:
        return lax.cummax(x, axis=x.ndim - 1)
    lead = x.shape[:-1]
    xc = x.reshape(*lead, n // chunk, chunk)
    inner = lax.cummax(xc, axis=x.ndim)  # scan of length `chunk`, vectorized
    totals = inner[..., -1]
    carry = lax.cummax(totals, axis=x.ndim - 1)  # scan of length n/chunk
    # exclusive shift of the carry: chunk i sees max of chunks < i
    pad = jnp.full((*lead, 1), jnp.iinfo(x.dtype).min, x.dtype) \
        if jnp.issubdtype(x.dtype, jnp.integer) \
        else jnp.full((*lead, 1), -jnp.inf, x.dtype)
    prev = jnp.concatenate([pad, carry[..., :-1]], axis=-1)
    return jnp.maximum(inner, prev[..., None]).reshape(*lead, n)
