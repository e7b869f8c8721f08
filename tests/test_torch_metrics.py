"""fedrann_tpu_torch's StageMetrics counters against the JAX package's:
`add_work` accumulates and `summary()` derives tflops_per_s, hbm_gb_per_s
(and, where the card's peaks are known, mfu_pct and hbm_util_pct) from
the same counters and seconds to the same floats (exact: the same float64
arithmetic); on the CPU there are no peaks, as on JAX's CPU devices. The
H100's peaks come from its name (stubbed here). The knn stage's flops and
d2h_bytes equal the JAX pipeline's on the same run (exact), under both
transfers; embed's hbm_bytes counts each distinct library row once."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedrann_tpu import metrics as jax_metrics
from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu.pipeline import run_pipeline as jax_run
from fedrann_tpu_torch import metrics
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.kmers.codec import PAD_SLOT
from fedrann_tpu_torch.knn.topk import (
    keys_to_host,
    merge_block,
    normalize_rows,
)
from fedrann_tpu_torch.pipeline import (
    StagedBucket,
    embed_hbm_bytes,
    run_pipeline,
)
from fedrann_tpu_torch.sim import simulate_reads, write_fasta

CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"

# (stage, seconds, counters): a zero counter adds no key
CASES = [
    ("knn", 2.5, dict(flops=2.0 * 15000 ** 2 * 512, d2h_bytes=6e6)),
    ("knn", 0.0, dict(flops=1e9)),             # no rate without seconds
    ("embed", 0.125, dict(hbm_bytes=3.5e9)),
    ("stage", 0.25, dict(h2d_bytes=1 << 20, flops=0.0)),
    ("embed", 0.125, dict(hbm_bytes=1.5e9, d2h_bytes=8.0)),
]


def _fill(m, stages: dict):
    for name, secs, counters in CASES:
        entry = stages.setdefault(name, {"seconds": 0.0,
                                         "peak_rss_mib": 100.0})
        entry["seconds"] += secs
        m.add_work(name, **counters)


def test_summary_equals_jax_without_peaks():
    jm, pm = jax_metrics.StageMetrics(), metrics.StageMetrics(CPU)
    _fill(jm, jm.stages)
    _fill(pm, pm._stages)
    ours = pm.summary()
    assert ours.pop("device") == {"type": "cpu", "name": "cpu"}
    assert ours == jm.summary()
    assert "tflops_per_s" in ours["knn"] and "mfu_pct" not in ours["knn"]
    assert "hbm_gb_per_s" in ours["embed"]
    assert ours["stage"] == {"seconds": 0.25, "peak_rss_mib": 100.0,
                             "h2d_bytes": float(1 << 20)}


def test_stage_records_seconds_and_peak_rss():
    m = metrics.StageMetrics(CPU)
    with m.stage("count"):
        with m.stage("stage"):
            pass
    m.add_work("stage", h2d_bytes=64)
    out = m.summary()
    for name in ("count", "stage"):
        assert out[name]["seconds"] >= 0
        assert out[name]["peak_rss_mib"] == pytest.approx(
            metrics.peak_rss_mib(), rel=0.5)
    assert out["stage"]["h2d_bytes"] == 64.0


def test_h100_peaks_give_mfu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    cuda = torch.device("cuda", 0)
    assert metrics.device_peaks(cuda) == (989e12, 3.35e12)
    assert metrics.device_peaks(CPU) is None
    m = metrics.StageMetrics(CPU)
    _fill(m, m._stages)
    m.device = cuda
    out = m.summary()
    knn, embed = out["knn"], out["embed"]
    assert knn["mfu_pct"] == round(
        100.0 * knn["flops"] / knn["seconds"] / 989e12, 2)
    assert embed["hbm_util_pct"] == round(
        100.0 * embed["hbm_bytes"] / embed["seconds"] / 3.35e12, 2)
    assert out["device"]["name"] == H100
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert metrics.device_peaks(cuda) is None
    assert "mfu_pct" not in m.summary()["knn"]


@pytest.mark.parametrize("transfer", ["f32", "u16"])
def test_knn_counters_equal_jax_pipeline(tmp_path, transfer):
    sim = simulate_reads(genome_length=8000, coverage=5,
                         mean_read_length=1200, error_rate=0.02, seed=5)
    path = str(tmp_path / "reads.fasta")
    write_fasta(path, sim.names, sim.sequences)
    args = ["-i", path, "-k", "13", "--kmer-sample-fraction", "0.3",
            "--seed", "602", "-n", "64", "--nndescent-n-neighbors", "8",
            "--knn-transfer", transfer]
    ours = run_pipeline(config_from_args(
        [*args, "-o", str(tmp_path / "torch")]), CPU).metrics["knn"]
    ref = jax_run(jax_config([*args, "-o", str(tmp_path / "jax")])
                  ).metrics["knn"]
    assert ours["flops"] == ref["flops"] > 0
    assert ours["d2h_bytes"] == ref["d2h_bytes"] > 0


@pytest.mark.parametrize("n_rows", [65536, 65537])
def test_u16_wire_is_exact(n_rows):
    """Indices up to 65,535 cross in two bytes under u16 (n_rows <=
    65,536), else as int32: both decode to the f32 wire's indices, and the
    distances to its distances snapped to the grid."""
    rng = np.random.default_rng(3)
    q, c = (normalize_rows(torch.from_numpy(
        rng.standard_normal((n, 8)).astype(np.float32))) for n in (6, 40))
    keys = merge_block(None, q, c, n_rows - 40, 9)
    idx32, dist32 = keys_to_host(keys, "f32", n_rows)
    idx16, dist16 = keys_to_host(keys, "u16", n_rows)
    assert idx32.max() == n_rows - 1 and idx32.min() >= n_rows - 40
    assert idx16.dtype == np.int32
    np.testing.assert_array_equal(idx16, idx32)
    assert np.abs(dist16 - dist32).max() <= 0.5 / 32767.5 + 1e-6


@pytest.mark.parametrize("form", ["signs", "dense"])
def test_embed_bytes_count_each_distinct_row_once(form):
    """Library rows 0, 1 and 3 are hit (row 0 on both strands, row 3 by a
    repeated slot), row 2 and the code 7 miss: three distinct table rows,
    plus every slot, target and hit count, the library and the output."""
    lib = torch.tensor([3, 5, 9, 11], dtype=torch.int64)
    slot = lambda code, fwd: (code << 1) | fwd  # noqa: E731
    staged = torch.tensor(
        [[slot(3, 0), slot(3, 1), slot(5, 1), slot(7, 1), PAD_SLOT],
         [slot(11, 1), slot(11, 1), PAD_SLOT, PAD_SLOT, PAD_SLOT]],
        dtype=torch.int64)
    bucket = StagedBucket(staged, torch.zeros(2, dtype=torch.int32),
                          torch.arange(2), rows=1)
    d = 32
    if form == "dense":
        proj, row = torch.zeros((5, 2 * d)), 2 * d * 4
    else:
        proj, row = (torch.zeros((5, 4), dtype=torch.int32),
                     torch.zeros(5)), 4 * 4 + 4
    want = 8 * 10 + 20 * 2 + 8 * 4 + 3 * row + 2 * 2 * d * 4
    assert embed_hbm_bytes([bucket], lib, proj, 2, d) == want
