"""fedrann_tpu_torch exact k-NN against the JAX `knn_exact`."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu.knn import topk as jtopk
from fedrann_tpu_torch.knn import topk


def _data(n=100, d=32, seed=13):
    e = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    e[7] = 0   # zero rows: distance exactly 1 to everything, so ties
    e[40] = 0
    return e


def test_knn_fp32_matches_jax_with_ties():
    """fp32: identical neighbors, zero-row ties resolved to the lowest
    index exactly as lax.top_k does."""
    e = _data()
    idx_j, dist_j = jtopk.knn_exact(e, 10, query_tile=16, precision="fp32")
    idx, dist = topk.knn_exact(torch.from_numpy(e), 10, query_tile=16,
                               precision="fp32")
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_allclose(dist, dist_j, atol=1e-5)
    np.testing.assert_array_equal(idx[7], np.arange(10))
    assert np.all(dist[7] == 1.0)


@pytest.mark.parametrize("candidate_tile", [16, 33])
def test_knn_running_merge_matches_one_block(candidate_tile):
    e = torch.from_numpy(_data(n=130))
    one = topk.knn_exact(e, 12, precision="fp32")
    blocked = topk.knn_exact(e, 12, query_tile=8,
                             candidate_tile=candidate_tile, precision="fp32")
    np.testing.assert_array_equal(blocked[0], one[0])
    # other matmul shapes may round a dot product by one ulp
    np.testing.assert_allclose(blocked[1], one[1], atol=1e-6)


def test_knn_bf16_tie_aware():
    """bf16 inputs, fp32 accumulation: the same distances to bf16
    tolerance (XLA's CPU bf16 dot and the port's f32 product of bf16-rounded
    rows round differently, by up to ~5e-4 here), and neighbor sets that
    differ at most by a boundary tie."""
    e = np.random.default_rng(14).normal(size=(256, 128)).astype(np.float32)
    idx_j, dist_j = jtopk.knn_exact(e, 5, precision="bf16")
    idx, dist = topk.knn_exact(torch.from_numpy(e), 5, precision="bf16")
    np.testing.assert_allclose(dist, dist_j, atol=2e-3)
    for r in range(len(e)):
        assert len(set(idx[r]) & set(idx_j[r])) >= 4, r
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(idx, idx_j)])
    assert agree > 0.99


def test_u16_distance_grid_matches_jax():
    d = np.linspace(-0.001, 2.0, 4097, dtype=np.float32).reshape(1, -1)
    want = jtopk.transfer_dist(jnp.asarray(d), "u16")
    got = topk.dequantize_dist(
        topk.quantize_dist(torch.from_numpy(d)).numpy())
    np.testing.assert_array_equal(got, want)


def test_normalize_rows_zero_row():
    e = torch.from_numpy(_data())
    n = topk.normalize_rows(e)
    assert torch.all(n[7] == 0)
    np.testing.assert_allclose(
        n.numpy(), np.asarray(jtopk.normalize_rows(jnp.asarray(e.numpy()))),
        rtol=1e-6, atol=1e-7)
