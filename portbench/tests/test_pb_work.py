"""The roofline and link arithmetic on known shapes, and the per-layer
readers on a synthetic trace."""

import pytest

from portbench import cells, work
from portbench.trace import Context, Trace, breakdown


def test_k4_bound_of_the_fly_exact_search():
    n, d = 574_904, 500
    assert work.k4_seconds(n, n, d, "bf16") == pytest.approx(
        2 * n * n * d / 989e12)
    assert work.k4_seconds(n, n, d, "bf16") == pytest.approx(0.334191, 1e-5)
    assert work.k4_seconds(n, n, d, "fp32") == pytest.approx(
        2 * n * n * d / 67e12)


def test_k6_bound_takes_the_larger_of_operations_and_bytes():
    # many pairs: bound by bf16 operations
    ops = work.k6_seconds(10**10, 1000, 8, 500, 50, "bf16")
    assert ops == pytest.approx(2 * 10**10 * 500 / 989e12)
    # few pairs: bound by the query gathers and the buffer
    by_bytes = work.k6_seconds(10, 10**6, 8, 500, 50, "bf16")
    assert by_bytes == pytest.approx(
        (10**6 * 8 * 500 * 2 + 10**6 * 8 * 50 * 8) / 3.35e12)
    assert work.k6_seconds(10, 10**6, 8, 500, 50, "fp32") == pytest.approx(
        (10**6 * 8 * 500 * 4 + 10**6 * 8 * 50 * 8) / 3.35e12)


def test_k10_bound_is_the_result_over_the_host_link():
    assert work.PEAK_HOST_LINK == pytest.approx(63.015e9, 1e-4)
    assert work.k10_seconds(1_493_738, 50) == pytest.approx(
        1_493_738 * 50 * 8 / work.PEAK_HOST_LINK)


def context(device, route="exact", ivf=(), rows=1000, k=50,
            spans=(("portbench.window", 0.0, 10.0),)):
    return Context(Trace(0.0, 10.0, list(device), list(spans)), route,
                   "bf16", rows, 500, k, 2, list(ivf))


def reader(name):
    return cells.load_reader(name)


def test_readers_on_a_synthetic_trace():
    rows = 100_000
    k4 = work.k4_seconds(rows, rows, 500, "bf16")
    k10 = work.k10_seconds(rows, 50)
    dev = [("void (anonymous namespace)::knn_merge_wgmma<true>(x)",
            1.0, 1.0 + 4 * k4),
           ("knn_merge_combine", 1.0 + 4 * k4, 1.0 + 5 * k4),
           ("keys_to_host_kernel<true, false, true>", 6.0, 6.0 + 2 * k10),
           ("Memcpy HtoD", 7.0, 8.0)]
    ctx = context(dev, rows=rows)
    assert reader("k4_roofline")(ctx) == pytest.approx(20.0)
    assert reader("k10_roofline")(ctx) == pytest.approx(50.0)
    busy = 5 * k4 + 2 * k10 + 1.0
    assert reader("device_idle_pct")(ctx) == pytest.approx(
        100 * (1 - busy / 10.0))
    assert reader("k6_roofline")(ctx) is None
    assert reader("ivf_pairs_per_row")(ctx) is None
    # one K4 launch kept, of 2 N^2 d operations, in a 10 s window
    assert reader("job_mfu")(ctx) == pytest.approx(100 * k4 / 10.0)


def test_ivf_readers():
    rows = 1_000_000
    stats = [{"clusters": 2048, "probes": 8, "real_pair_scores": 2 * 10**10},
             {"clusters": 2048, "probes": 8, "real_pair_scores": 10**10}]
    k6 = (work.k6_seconds(2 * 10**10, rows, 8, 500, 50, "bf16")
          + work.k6_seconds(10**10, rows, 8, 500, 50, "bf16")) / 2
    k4 = work.k4_seconds(rows, 2048, 500, "bf16")
    dev = [("ivf_rescore_kernel<true, true>", 0.0, 4 * k6),
           ("ivf_rescore_kernel<true, true>", 5.0, 5.0 + 4 * k6),
           ("knn_merge_wgmma<true>", 8.0, 8.0 + 10 * k4)]
    ctx = context(dev, "ivf", stats, rows)
    assert reader("k6_roofline")(ctx) == pytest.approx(25.0)
    assert reader("ivf_pairs_per_row")(ctx) == pytest.approx(15_000.0)
    assert reader("k4_roofline")(ctx) == pytest.approx(10.0)
    # one K4 launch and two K6 launches kept, each K6 at the jobs' mean
    kept = k4 + 2 * sum(2.0 * s["real_pair_scores"] * 500 / 989e12
                        for s in stats) / 2
    assert reader("job_mfu")(ctx) == pytest.approx(100 * kept / 10.0)


def test_readers_find_nothing_in_an_empty_trace():
    ctx = context([])
    for m in cells.load_benchmark(cells.HERE.parent)["per_layer"]:
        assert reader(m["name"])(ctx) is None


def test_breakdown_labels_gaps_by_the_host_span():
    spans = [("portbench.window", 0.0, 10.0),
             ("portbench.search", 0.0, 4.0),
             ("portbench.release", 4.0, 6.0),
             ("portbench.search", 6.0, 10.0)]
    dev = [("a", 0.5, 3.5), ("b", 3.0, 4.0), ("a", 6.5, 9.0)]
    tr = Trace(0.0, 10.0, dev, spans)
    assert tr.busy_s == pytest.approx(3.5 + 2.5)
    out = breakdown(tr)
    assert out["device_ops"] == [["a", pytest.approx(5.5)],
                                 ["b", pytest.approx(1.0)]]
    assert out["idle_gaps"][0] == ["portbench.release", pytest.approx(2.5)]
    assert {g[0] for g in out["idle_gaps"]} == {"portbench.release",
                                                "portbench.search"}
