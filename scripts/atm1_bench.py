"""ATM1 (sharded megablock container) ratio + recovery-decode bench.

Runs standalone on a virtual 8-device CPU mesh (the encode needs an sp
mesh; bench.py runs on one card) and prints ONE JSON line with
``atm1_ratio`` and ``atm1_decode_mbps`` (the recovery-decode rate).
bench.py invokes this as a subprocess and merges the fields; the CPU is
forced before the backend starts, so the child never claims the card.
"""

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 22

    from archon_tpu.parallel import megapipe
    from archon_tpu.parallel.blocks import make_mesh
    from archon_tpu.utils.corpus import load_or_synthesize

    _, data = load_or_synthesize(size)
    data = data[:size]
    mesh = make_mesh({"sp": 8}, devices=jax.devices()[:8])
    blob = megapipe.encode_megablock(data, mesh, "a4")
    out = megapipe.decode_megablock(blob)
    assert out == data
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        megapipe.decode_megablock(blob)
        times.append(time.perf_counter() - t0)
    print(
        json.dumps(
            {
                "atm1_ratio": round(len(blob) / len(data), 4),
                "atm1_decode_mbps": round(size / 1e6 / min(times), 2),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
