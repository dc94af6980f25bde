"""IT-N machinery and research-tool ports."""

import numpy as np

from archon_tpu.ops.itn import it_masks, it2_lucky, itoh_tanaka_sa, wave_counts
from archon_tpu.golden import sa as golden
from archon_tpu.utils import tools
from archon_tpu.utils.corpus import text_like, gauntlet_cases


def test_itoh_tanaka_matches_golden():
    rng = np.random.default_rng(11)
    cases = [np.frombuffer(text_like(3000), np.uint8)]
    for _ in range(6):
        n = int(rng.integers(2, 500))
        a = int(rng.integers(2, 200))
        cases.append(rng.integers(0, a, n, dtype=np.uint8))
    cases.append(np.frombuffer(gauntlet_cases(512)["fibonacci"], np.uint8))
    for arr in cases:
        want = golden.suffix_array(arr, "small")
        got = itoh_tanaka_sa(arr)
        assert got.tolist() == want.tolist(), f"n={len(arr)}"


def test_it2_direct_fraction_matches_reference_claim():
    # the reference reports ~1/3 of suffixes directly sorted under IT-2
    # (final/x1/ArchonX1.c:6, a4 genprint)
    data = np.frombuffer(text_like(100000), np.uint8)
    wc = wave_counts(data)
    frac = wc["direct"] / wc["total"]
    assert 0.15 < frac < 0.5


def test_masks_shape():
    data = np.frombuffer(b"cabbage", np.uint8)
    m = it_masks(data, 4)
    assert m.shape == (7,) and m.dtype == np.uint8


def test_tools_run():
    data = np.frombuffer(text_like(20000), np.uint8)
    est = tools.estimate_it_groups(data, 3)
    assert abs(sum(est.values()) - 1.0) < 1e-9
    bps = tools.huffman_bits_per_sym(data)
    assert 1.0 < bps < 8.0
    vol = tools.reorder_direct_volume(data)
    # all 7 reference estimator variants (reorder.c:346-359), sane ranges
    assert set(vol) == {"it1", "it1x", "it1y", "it1s", "it12x", "it2", "it2x1"}
    assert 0 < vol["it2"]["flat"] <= vol["it1"]["flat"] <= 1
    for v in vol.values():
        assert 0 <= v["flat"] <= 1 and v["logc"] >= 0
    # the "extreme" greedy variants must not sort more than plain IT-1
    assert vol["it1x"]["flat"] <= vol["it1"]["flat"] + 1e-9

    res = tools.route_search(3)
    # the brute force must find a plan cheaper than sorting everything (1.0)
    assert 0 < res["volume"] < 1.0
    assert res["plan"], "plan must be non-empty"
    # every derivation source must be a valid group id for ORDER=3
    for g, choice in res["plan"].items():
        assert 1 <= g < 16
        if choice != "DIRECT":
            dep_type, srcs = choice
            assert dep_type in ("SUFFIX", "PREFIX", "PERIOD")
            assert all(1 <= s < 16 for s in srcs)


def test_varadix_orders():
    import numpy as np
    from archon_tpu.utils.tools import varadix_orders

    # 4-symbol alphabet, 16-bit budget: exact base-4 packs 8 symbols
    data = np.frombuffer((b"acgt" * 100), np.uint8)
    r = varadix_orders(data, 16)
    assert r["symbols"] == 4
    assert r["exact_order"] == 8
    assert r["pow2_order"] == 8
    assert r["pow2_utilization"] == 1.0

    # 5-symbol alphabet: exact base-5 beats 3-bit pow2 keys
    data5 = np.frombuffer((b"acgtn" * 100), np.uint8)
    r5 = varadix_orders(data5, 16)
    assert r5["symbols"] == 5
    assert r5["exact_order"] == 6   # 5^6 = 15625 <= 65536
    assert r5["pow2_order"] == 5    # 16 // 3
    assert 0 < r5["pow2_utilization"] < 1


def test_memory_report():
    from archon_tpu.utils.tools import memory_report

    r = memory_report(1 << 20)
    assert r["total_bytes"] == r["bytes_per_input_byte"] * (1 << 20)
    # doubling-family working set is O(N) with a modest constant (the
    # reference's 5N budget becomes ~50N of i32 sort operands on device —
    # reported, as the reference reports its own)
    assert 20 <= r["bytes_per_input_byte"] <= 100
