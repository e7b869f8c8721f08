"""The spans inside the search job (metrics.span, metrics.steps) and the
IVF's per-call record in knn_ivf.last, and the benchmark's readers of that
record (portbench/metrics: ivf_kmeans_ms, wire_pin_ms, pinned_host_gib).

With no profiler running a span is one shared null context and the search
records nothing; under a torch profiler the spans add up their host
seconds, and only the program's own --profile makes them ranges of the
trace. The card's record (device ms a step, page-locked takes and bytes)
is checked by the `cuda` test at the end, which needs a CUDA device:
    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fedrann_tpu_torch import metrics, pipeline
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.knn import ivf, topk
from fedrann_tpu_torch.sim import simulate_reads, write_fasta
from portbench import cells
from portbench.trace import Context, Trace

# the keys knn_ivf.last holds on every call, recorded or not
IVF_KEYS = {"pair_scores", "size_classes", "probed_clusters",
            "real_pair_scores", "max_members", "rows", "clusters",
            "probes", "spill"}
IVF_STEPS = ["normalize", "kmeans", "probes", "members", "rescore", "merge"]
CARD_KEYS = {"device_ms", "pin_s", "unpin_s", "pinned_bytes"}
# the key a search on a card adds on every call: K6's row pitch
K6_KEYS = {"k6_row_pitch"}


def _rows(n=2400, d=32, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((24, d))
    rows = centres[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal(
        (n, d))
    return torch.from_numpy(rows.astype(np.float32))


def _ivf(rows):
    return ivf.knn_ivf(rows, 10, n_clusters=16, n_probes=4)


def _no_recording(*args, **kwargs):
    raise AssertionError("a span recorded with no profiler running")


def test_a_span_with_no_profiler_is_the_shared_null_context(monkeypatch):
    assert metrics.span("fedrann.test") is metrics._NULL
    assert metrics.steps(torch.device("cpu")) is metrics.NO_STEPS
    assert metrics.NO_STEPS.step("fedrann.test") is metrics._NULL
    before = dict(metrics.span.seconds)
    monkeypatch.setattr(torch.profiler, "record_function", _no_recording)
    monkeypatch.setattr(torch.cuda, "Event", _no_recording)
    monkeypatch.setattr(metrics, "_Span", _no_recording)
    monkeypatch.setattr(metrics, "Steps", _no_recording)
    rows = _rows()
    _ivf(rows)
    assert set(ivf.knn_ivf.last) == IVF_KEYS
    topk.knn_exact(rows, 10)
    assert metrics.span.seconds == before


def test_the_searches_record_their_spans_under_a_cpu_profiler():
    rows = _rows()
    want_ivf, want_exact = _ivf(rows), topk.knn_exact(rows, 10)
    before = dict(metrics.span.seconds)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got_ivf = _ivf(rows)
        last = dict(ivf.knn_ivf.last)
        got_exact = topk.knn_exact(rows, 10)
    for got, want in ((got_ivf, want_ivf), (got_exact, want_exact)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # no card-only key on the CPU
    assert set(last) == IVF_KEYS
    grew = {name for name, secs in metrics.span.seconds.items()
            if secs > before.get(name, 0.0)}
    assert grew == ({f"fedrann.ivf.{s}" for s in IVF_STEPS + ["plan"]}
                    | {"fedrann.knn.normalize", "fedrann.knn.merge"})
    # outside --profile no span is a range of another profiler's trace
    assert not [e.name for e in prof.events()
                if e.name.startswith("fedrann.")]
    assert not metrics.span.ranges


def test_steps_span_and_mark_in_order_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        spans = metrics.steps(torch.device("cpu"))
        assert isinstance(spans, metrics.Steps) and not spans.timed
        with spans.step("fedrann.test.step"):
            pass
        spans.mark("wire")
        assert spans.events == [] and spans.record() == {}
    assert metrics.span.seconds["fedrann.test.step"] > 0


# the keys knn_ivf.last adds over a mesh, recorded or not, and those a
# mesh search on cards records under a profiler
MESH_KEYS = {"entries", "entry_rows", "entry_pairs"}
MESH_CARD_KEYS = CARD_KEYS | {"serial_ms", "entry_ms", "wire_s"}
SERIAL_STEPS = ["normalize", "kmeans", "probes", "members", "replicate"]


def test_a_mesh_search_records_its_spans_under_a_cpu_profiler():
    """knn_ivf over four CPU entries: its spans (the first device's
    steps, the replication, each entry's rescore and wire, the gather)
    under a CPU profiler, its entries' counts with or without one, and no
    card-only key on the CPU."""
    from fedrann_tpu_torch.parallel.mesh import make_mesh

    rows, mesh = _rows(), make_mesh(devices=[torch.device("cpu")] * 4)
    ivf.knn_ivf(rows, 10, n_clusters=16, n_probes=4, mesh=mesh)
    assert set(ivf.knn_ivf.last) == IVF_KEYS | MESH_KEYS
    before = dict(metrics.span.seconds)
    with profile(activities=[ProfilerActivity.CPU]):
        ivf.knn_ivf(rows, 10, n_clusters=16, n_probes=4, mesh=mesh)
    last = ivf.knn_ivf.last
    assert set(last) == IVF_KEYS | MESH_KEYS
    assert last["entries"] == 4 and sum(last["entry_rows"]) == 2400
    assert sum(last["entry_pairs"]) == last["real_pair_scores"]
    grew = {name for name, secs in metrics.span.seconds.items()
            if secs > before.get(name, 0.0)}
    assert grew == {f"fedrann.ivf.{s}" for s in SERIAL_STEPS + [
        "rescore", "merge", "plan", "gather"]}


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    sim = simulate_reads(genome_length=12000, coverage=5,
                         mean_read_length=1500, error_rate=0.02, seed=8)
    path = str(d / "reads.fasta.gz")
    write_fasta(path, sim.names, sim.sequences)
    return path


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") == name]


def test_a_profile_run_nests_the_search_steps_in_its_trace(reads, tmp_path):
    from test_torch_native_io import _host_toolchain_missing

    if _host_toolchain_missing():
        pytest.skip(_host_toolchain_missing())
    out = str(tmp_path / "out")
    pipeline.run_pipeline(config_from_args(
        ["-i", reads, "-o", out, "-k", "13", "--kmer-sample-fraction",
         "0.2", "-n", "64", "--nndescent-n-neighbors", "8", "--profile"]),
        torch.device("cpu"))
    assert not metrics.span.ranges
    with open(os.path.join(out, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    (knn,) = _ranges(events, "stage:knn")
    (search,) = _ranges(events, "fedrann.search")
    (normalize,) = _ranges(events, "fedrann.knn.normalize")
    (merge,) = _ranges(events, "fedrann.knn.merge")
    assert knn[0] <= search[0] and search[1] <= knn[1]
    assert search[0] <= normalize[0] <= normalize[1] <= merge[0]
    assert merge[1] <= search[1]


def _record(kmeans, pin_s, unpin_s, pinned):
    return {"clusters": 2048, "probes": 8, "real_pair_scores": 10**10,
            "device_ms": {"normalize": 1.0, "kmeans": kmeans, "wire": 9.0},
            "pin_s": pin_s, "unpin_s": unpin_s, "pinned_bytes": pinned}


def _context(route, stats):
    return Context(Trace(0.0, 10.0, [], [("portbench.window", 0.0, 10.0)]),
                   route, "bf16", 1000, 500, 50, len(stats), stats)


GIB = float(1 << 30)
STATS = [_record(50.0, 0.1, 0.05, 1.0 * GIB),
         _record(70.0, 0.2, 0.15, 1.5 * GIB)]


@pytest.mark.parametrize("name,want", [
    ("ivf_kmeans_ms", 60.0),
    ("wire_pin_ms", (150.0 + 350.0) / 2),
    ("pinned_host_gib", 1.5),
])
def test_a_reader_of_the_ivf_record(name, want):
    read = cells.load_reader(name)
    assert read(_context("ivf", STATS)) == pytest.approx(want)
    # no key (the CPU, an untimed call), another route, nothing traced
    bare = [{k: v for k, v in s.items() if k not in CARD_KEYS}
            for s in STATS]
    assert read(_context("ivf", bare)) is None
    assert read(_context("exact", STATS)) is None
    assert read(_context("ivf", [])) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: reads the card's record of a "
                    "search")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_card_search_records_each_device_step(cuda, monkeypatch):
    """Under a profiler, knn_ivf on a card records each step's device ms
    and the page-locked bytes, which grow by a HostBlock's bytes while a
    result past PIN_CACHE_BYTES is held; with no profiler it records none
    of it."""
    monkeypatch.setattr(topk, "PIN_CACHE_BYTES", 0)
    rows = _rows(6000, 64).to(cuda)
    _ivf(rows)  # every kernel built
    assert set(ivf.knn_ivf.last) == IVF_KEYS | K6_KEYS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        first = _ivf(rows)
        one = dict(ivf.knn_ivf.last)
        second = _ivf(rows)
        two = dict(ivf.knn_ivf.last)
        del first
        third = _ivf(rows)
        three = dict(ivf.knn_ivf.last)
    assert set(one) == IVF_KEYS | K6_KEYS | CARD_KEYS
    assert list(one["device_ms"]) == IVF_STEPS + ["wire"]
    assert all(ms > 0 for ms in one["device_ms"].values())
    block = 2 * 6000 * 10 * 4
    assert two["pinned_bytes"] - one["pinned_bytes"] == block
    assert three["pinned_bytes"] == two["pinned_bytes"]
    assert one["pin_s"] > 0 and three["unpin_s"] > 0
    assert two["unpin_s"] == 0.0
    np.testing.assert_array_equal(second[0], third[0])


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: reads the record of a search "
                    "sharded over them")
    from fedrann_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[torch.device("cuda", i) for i in range(4)])


@pytest.mark.cuda
def test_a_four_card_search_records_each_entry(four_cards):
    """Under a profiler, knn_ivf_sharded over four cards records the first
    card's serial steps and their sum (serial_ms), each entry's device ms
    on its own card (its lists' copy, rescore, merge, the wait for its
    wire, the wire), the host's wire seconds and the page-locked takes;
    the result is the untraced call's."""
    rows = _rows(20000, 64).to(four_cards.devices[0])
    want = ivf.knn_ivf_sharded(rows, 10, mesh=four_cards, n_clusters=16,
                               n_probes=4)  # every kernel built
    assert set(ivf.knn_ivf.last) == IVF_KEYS | K6_KEYS | MESH_KEYS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = ivf.knn_ivf_sharded(rows, 10, mesh=four_cards, n_clusters=16,
                                  n_probes=4)
    last = ivf.knn_ivf.last
    assert set(last) == IVF_KEYS | K6_KEYS | MESH_KEYS | MESH_CARD_KEYS
    assert list(last["device_ms"]) == SERIAL_STEPS
    assert last["serial_ms"] == pytest.approx(
        sum(last["device_ms"].values()))
    assert last["entries"] == len(last["entry_ms"]) == 4
    for ms in last["entry_ms"]:
        assert list(ms) == ["lists", "rescore", "merge", "held", "wire"]
        assert ms["rescore"] > 0 and ms["wire"] > 0
    assert last["wire_s"] > 0 and last["pin_s"] > 0
    assert last["pinned_bytes"] > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
