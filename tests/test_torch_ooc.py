"""fedrann_tpu_torch's out-of-core k-NN (knn/ooc.py) and the pipeline's
out-of-core path (--knn-hbm-budget) against the JAX package, on the CPU.

The wire matrix (host_wire) is bitwise the JAX package's; the search gives
JAX's `knn_exact_ooc` indices at fp32 (distances within 1e-5) and at bf16
(agreement >= 0.999, sorted distances within 2e-3), and its own
`knn_exact`'s on the same wire rows; the plan stays within its budget; the
whole run matches JAX's at the budget that trips the valve; and each
package's out-of-core checkpoint (bfloat16 bits, numpy's |V2) is resumed
by the port."""

from __future__ import annotations

import io
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import fedrann_tpu.pipeline as jax_pipeline
from fedrann_tpu.cli import config_from_args as jax_config
from fedrann_tpu.knn import ooc as jooc
from fedrann_tpu_torch import pipeline
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.knn import ooc
from fedrann_tpu_torch.knn.topk import knn_exact
from fedrann_tpu_torch.sim import simulate_reads, write_fasta
from test_torch_native_io import host_toolchain  # noqa: F401

CPU = torch.device("cpu")
# (n, d, k, budget bytes, block_rows, query_tile): each budget gives both
# packages' plans at least two query slabs and two candidate blocks
CASES = [(700, 64, 10, 300_000, 256, 128), (900, 48, 8, 300_000, 256, 128),
         (5000, 64, 10, 1_500_000, 1024, 256)]
# tests/test_knn_ooc.py's pipeline shape: ~320 reads of 3 kb, d = 512
ARGS = ["-k", "15", "--kmer-sample-fraction", "0.05", "-n", "512",
        "--nndescent-n-neighbors", "10", "--seed", "602",
        "--knn-transfer", "f32", "--knn-hbm-budget", "1M"]


def _emb(n, d, seed=0):
    """tests/test_knn_ooc.py's rows: rank 16 plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 16)).astype(np.float32)
    mix = rng.standard_normal((16, d)).astype(np.float32)
    return base @ mix + 0.25 * rng.standard_normal((n, d)).astype(np.float32)


def _agreement(a, b):
    return np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, b)])


def _reset_counts():
    ooc.knn_exact_ooc.slabs = 0
    ooc.knn_exact_ooc.blocks_uploaded = 0
    ooc.knn_exact_ooc.h2d_bytes = 0


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_host_wire_matches_jax_bitwise(precision, monkeypatch):
    """host_wire against `fedrann_tpu/knn/ooc.py:136-142` reproduced with
    ml_dtypes, across wire chunks, with zero rows; from numpy and from a
    bfloat16 CPU tensor; the input unchanged."""
    monkeypatch.setattr(ooc, "WIRE_CHUNK", 128)
    e = _emb(300, 40, seed=5) * np.float32(7.5)
    e[[3, 129]] = 0
    wire_dtype = ml_dtypes.bfloat16 if precision == "bf16" else np.float32
    bits = np.int16 if precision == "bf16" else np.int32

    def jax_lines(emb):
        host = np.empty(emb.shape, wire_dtype)
        for s in range(0, emb.shape[0], 1 << 20):
            x = np.asarray(emb[s : s + (1 << 20)], np.float32)
            norms = np.linalg.norm(x, axis=1, keepdims=True)
            host[s : s + (1 << 20)] = (
                x / np.where(norms == 0, 1.0, norms)).astype(wire_dtype)
        return host.view(bits)

    before = e.copy()
    got = ooc.host_wire(e, precision)
    np.testing.assert_array_equal(e, before)
    np.testing.assert_array_equal(got.view(getattr(torch, bits.__name__))
                                  .numpy(), jax_lines(e))
    t = torch.from_numpy(e).to(torch.bfloat16)
    got = ooc.host_wire(t, precision)
    np.testing.assert_array_equal(
        got.view(getattr(torch, bits.__name__)).numpy(),
        jax_lines(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}")
def test_ooc_matches_jax_ooc(case, precision):
    n, d, k, budget, block_rows, qt = case
    e = _emb(n, d, seed=n)
    kw = dict(hbm_budget=budget, block_rows=block_rows, query_tile=qt,
              precision=precision, transfer="f32")
    idx_j, dist_j = jooc.knn_exact_ooc(e, k, **kw)
    _reset_counts()
    idx, dist = ooc.knn_exact_ooc(e, k, device=CPU, **kw)
    itemsize = 2 if precision == "bf16" else 4
    q_rows, c_rows, _ = ooc.plan_ooc(n, d, k, budget, qt, block_rows,
                                     itemsize)
    slabs, blocks = -(-n // q_rows), -(-n // c_rows)
    assert slabs >= 2 and blocks >= 2
    assert ooc.knn_exact_ooc.slabs == slabs
    assert ooc.knn_exact_ooc.blocks_uploaded == slabs * blocks
    assert ooc.knn_exact_ooc.h2d_bytes == (slabs + 1) * n * d * itemsize
    assert idx.dtype == np.int32 and dist.dtype == np.float32
    assert (idx[:, 0] == np.arange(n)).mean() > 0.99
    if precision == "fp32":
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_allclose(dist, dist_j, atol=1e-5)
    else:
        assert _agreement(idx, idx_j) >= 0.999
        np.testing.assert_allclose(np.sort(dist, 1), np.sort(dist_j, 1),
                                   atol=2e-3)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}")
def test_ooc_matches_own_knn_exact_fp32(case):
    """The streamed search and knn_exact over the same fp32 wire rows, with
    the same tiles: identical indices."""
    n, d, k, budget, block_rows, qt = case
    e = _emb(n, d, seed=n + 1)
    _, _, ct = ooc.plan_ooc(n, d, k, budget, qt, block_rows, 4)
    idx, dist = ooc.knn_exact_ooc(e, k, budget, query_tile=qt,
                                  block_rows=block_rows, precision="fp32",
                                  device=CPU)
    idx_e, dist_e = knn_exact(ooc.host_wire(e, "fp32"), k, query_tile=qt,
                              candidate_tile=ct, precision="fp32")
    np.testing.assert_array_equal(idx, idx_e)
    np.testing.assert_allclose(dist, dist_e, atol=1e-6)


@pytest.mark.parametrize("budget", ["16M", "64M", "256M", "2G", "8G"])
def test_plan_holds_its_budget(budget):
    from fedrann_tpu_torch.cli import parse_bytes

    b = parse_bytes(budget)
    for n in (15_000, 262_144, 40_000_000):
        for d, k, itemsize in ((512, 50, 2), (512, 50, 4), (128, 10, 2),
                               (512, 100, 2)):
            q, c, ct = ooc.plan_ooc(n, d, k, b, 512, ooc.DEFAULT_BLOCK_ROWS,
                                    itemsize)
            assert q % 512 == 0 and q >= 512
            assert c & (c - 1) == 0 and ct & (ct - 1) == 0 and ct <= c
            assert 2 * c * d * itemsize <= b // 3 or c <= 512
            assert ooc.plan_bytes(q, c, ct, 512, d, k, itemsize) <= b
    # the JAX package's plan at 256 MiB: 3 slabs x 8 blocks of 32,768 rows;
    # the port's keeps the blocks and counts its own merge temporaries in
    # the widest candidate tile that fits, which leaves smaller slabs
    if budget == "256M":
        q_j, c_j = jooc.plan_ooc(262_144, 512, 50, b)
        assert (-(-262_144 // q_j), c_j) == (3, 32_768)
        q, c, ct = ooc.plan_ooc(262_144, 512, 50, b)
        assert (-(-262_144 // q), c, ct) == (12, 32_768, 16_384)


@pytest.mark.parametrize("budget", ["16M", "64M", "256M", "2G", "8G"])
def test_card_plan_holds_its_budget(budget):
    """The plan for a card of 132 SMs (K4's own footprint: the slab, its
    carry, two blocks, K4's split scratch, the decode) holds the budget
    over test_plan_holds_its_budget's grid, its slab and block one K4
    launch; at 262,144 x 512 and 256 MiB it needs fewer slabs than the
    CPU plan's 12."""
    from fedrann_tpu_torch.cli import parse_bytes

    b = parse_bytes(budget)
    for n in (15_000, 262_144, 40_000_000):
        for d, k, itemsize in ((512, 50, 2), (512, 50, 4), (128, 10, 2),
                               (512, 100, 2)):
            q, c, ct = ooc.plan_ooc(n, d, k, b, 512, ooc.DEFAULT_BLOCK_ROWS,
                                    itemsize, sms=132)
            assert q % 512 == 0 and q >= 512
            assert c & (c - 1) == 0 and ct == c
            assert 2 * c * d * itemsize <= b // 3 or c <= 512
            assert ooc.plan_bytes(q, c, ct, 512, d, k, itemsize, 132) <= b
    if budget == "256M":
        q_cpu, _, _ = ooc.plan_ooc(262_144, 512, 50, b)
        q, c, _ = ooc.plan_ooc(262_144, 512, 50, b, sms=132)
        assert -(-262_144 // q_cpu) == 12
        assert -(-262_144 // q) < 12 and c == 32_768


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [100, 13, 512])
def test_card_plan_counts_k4_padded_copies(d, itemsize):
    """Where a row's bytes are not a multiple of 16, K4 reads zero-padded
    copies of the slab and the block (topk.tma_width): the card's plan
    counts both beside the rest and still holds its budget, and at a d K4
    reads as it is the plan is the one without copies."""
    from fedrann_tpu_torch.knn.topk import tma_width

    padded = tma_width(d, itemsize)
    for budget in (16 << 20, 256 << 20):
        q, c, ct = ooc.plan_ooc(262_144, d, 50, budget, 512,
                                ooc.DEFAULT_BLOCK_ROWS, itemsize, sms=132)
        held = ooc.plan_bytes(q, c, ct, 512, d, 50, itemsize, 132)
        assert q % 512 == 0 and held <= budget
        copies = (q + c) * padded * itemsize if padded != d else 0
        units = ooc.k4_units(q, c, 50, 132)
        assert held >= (q * (d * itemsize + 50 * 8) + 2 * c * d * itemsize
                        + (units * q * 50 * 8 if units > 1 else 0) + copies)
        assert (padded == d) == (d * itemsize % 16 == 0)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("ooc")
    sim = simulate_reads(genome_length=120_000, coverage=8,
                         mean_read_length=3000, error_rate=0.03, seed=11)
    path = str(d / "reads.fasta")
    write_fasta(path, sim.names, sim.sequences)
    return path


@pytest.mark.usefixtures("host_toolchain")
def test_pipeline_ooc_matches_jax(reads, tmp_path):
    """run_pipeline(config, cpu) at --knn-hbm-budget 1M against JAX's:
    the valve trips in both, the embeddings are a host bfloat16 matrix
    equal to JAX's within rtol 1e-2, neighbor agreement >= 0.99 and
    distances within 5e-3; --save-feature-matrix saves the host matrix's
    bits."""
    out = str(tmp_path / "torch")
    _reset_counts()
    res = pipeline.run_pipeline(config_from_args(
        ["-i", reads, "-o", out, *ARGS, "--save-feature-matrix"]), CPU)
    ref = jax_pipeline.run_pipeline(jax_config(
        ["-i", reads, "-o", str(tmp_path / "jax"), *ARGS]))
    assert ooc.knn_exact_ooc.slabs >= 1
    assert res.metrics["knn"]["h2d_bytes"] == ooc.knn_exact_ooc.h2d_bytes
    emb = res.embeddings
    assert emb.dtype == torch.bfloat16 and emb.device == CPU
    assert isinstance(ref.embeddings, np.ndarray)
    np.testing.assert_allclose(emb.float().numpy(),
                               np.asarray(ref.embeddings, np.float32),
                               rtol=1e-2, atol=1e-2)
    assert _agreement(res.neighbor_indices, ref.neighbor_indices) >= 0.99
    assert np.abs(np.sort(res.neighbor_distances, 1)
                  - np.sort(ref.neighbor_distances, 1)).max() < 5e-3
    saved = np.load(os.path.join(out, "feature_matrix.npz"))["embeddings"]
    np.testing.assert_array_equal(saved.view(np.int16),
                                  emb.view(torch.int16).numpy())
    with open(os.path.join(out, "fedrann.log")) as f:
        log = f.read()
    assert "out-of-core path" in log and "query slabs" in log


def _no_staging(*args, **kwargs):
    raise AssertionError("a resumed run staged the reads")


@pytest.mark.usefixtures("host_toolchain")
def test_jax_ooc_checkpoint_resumed_by_port(reads, tmp_path, monkeypatch):
    """JAX's out-of-core embeddings.npy (ml_dtypes bfloat16, |V2 to
    numpy) resumes in the port out of core (host bfloat16, bitwise the
    file) and in core (float32 on the device); the JAX package itself
    raises TypeError on that file."""
    out = str(tmp_path / "out")
    args = ["-i", reads, "-o", out, *ARGS, "--keep-intermediates"]
    ref = jax_pipeline.run_pipeline(jax_config(args))
    saved = np.load(os.path.join(out, "checkpoints", "embeddings.npy"))
    assert saved.dtype.kind == "V" and saved.dtype.itemsize == 2
    monkeypatch.setattr(pipeline, "stage_reads", _no_staging)
    res = pipeline.run_pipeline(config_from_args(args), CPU)
    assert "stage" not in res.metrics
    np.testing.assert_array_equal(
        res.embeddings.view(torch.int16).numpy(), saved.view(np.int16))
    assert _agreement(res.neighbor_indices, ref.neighbor_indices) >= 0.99
    in_core = [a for a in args if a not in ("--knn-hbm-budget", "1M")]
    res = pipeline.run_pipeline(config_from_args(in_core), CPU)
    assert res.embeddings.dtype == torch.float32
    np.testing.assert_array_equal(
        res.embeddings.numpy(),
        torch.from_numpy(saved.view(np.int16)).view(torch.bfloat16).float()
        .numpy())
    with pytest.raises(TypeError):
        jax_pipeline.run_pipeline(jax_config(in_core))


@pytest.mark.usefixtures("host_toolchain")
def test_port_ooc_checkpoint_resumed(reads, tmp_path, monkeypatch):
    """The port's out-of-core checkpoint is the bytes numpy writes for
    JAX's ml_dtypes array, and the port resumes it without staging, to
    the same overlaps.tsv; --knn-sharded always streams through one device
    with a warning."""
    out = str(tmp_path / "out")
    args = ["-i", reads, "-o", out, *ARGS, "--keep-intermediates",
            "--knn-sharded", "always"]
    first = pipeline.run_pipeline(config_from_args(args), CPU)
    path = os.path.join(out, "checkpoints", "embeddings.npy")
    want = io.BytesIO()
    np.save(want, first.embeddings.view(torch.int16).numpy()
            .view(ml_dtypes.bfloat16))
    with open(path, "rb") as f:
        assert f.read() == want.getvalue()
    with open(os.path.join(out, "fedrann.log")) as f:
        assert "out-of-core k-NN streams through one device" in f.read()
    with open(first.overlaps_path, "rb") as f:
        tsv = f.read()
    monkeypatch.setattr(pipeline, "stage_reads", _no_staging)
    res = pipeline.run_pipeline(config_from_args(args), CPU)
    assert torch.equal(res.embeddings, first.embeddings)
    with open(res.overlaps_path, "rb") as f:
        assert f.read() == tsv
