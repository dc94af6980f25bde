"""archon_tpu — a block-sorting compression framework in JAX.

The reference (kvark/dark-archon) family re-designed for an accelerator:
forward BWT via batched prefix-quadrupling suffix sorts (jit/XLA), inverse
BWT via a native C++ MLP cycle walk, the a6 entropy stage
(exact Huffman + device bit-pack), block-streamed and mesh-sharded
containers.  See README.md for the architecture map.

Top-level convenience API (lazily imported; none of these trigger JAX
backend initialization at package import time):

    encode(data, generation)    / decode(blob, generation)   # a4/a7 format
    a6_encode(data, config)     / a6_decode(blob, config)    # a6 format
    encode_file(data, ...)      / decode_file(blob, ...)     # container
    ArchonConfig                                             # config object
"""

from __future__ import annotations

__version__ = "0.4.0"

_LAZY = {
    "encode": ("archon_tpu.formats", "encode"),
    "decode": ("archon_tpu.formats", "decode"),
    "a6_encode": ("archon_tpu.core.a6", "a6_encode"),
    "a6_decode": ("archon_tpu.core.a6", "a6_decode"),
    "encode_file": ("archon_tpu.io.blocks", "encode_file"),
    "decode_file": ("archon_tpu.io.blocks", "decode_file"),
    "encode_to_path": ("archon_tpu.io.blocks", "encode_to_path"),
    "ArchonConfig": ("archon_tpu.config", "ArchonConfig"),
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'archon_tpu' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__
