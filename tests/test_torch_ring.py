"""fedrann_tpu_torch's sharded k-NN (ring, allgather, ring2d over a mesh of
eight `cpu` entries) against the JAX `knn_exact_sharded` on its 8-device
CPU mesh, case by case as tests/test_sharded_knn.py, and against the
port's own `knn_exact`; and the mesh helpers.

Against JAX: distances within 1e-4 at fp32 and 2e-3 at bf16 (XLA's CPU
bf16 dot and the port's float32 product of bf16-rounded rows round
differently; tests/test_torch_knn.py's bar), at least 9 of 10 indices
shared per row, no index >= N or < 0. JAX's ring breaks ties by arrival
order, the port by the lowest index (a deliberate divergence), so indices
are compared as sets. Against the port's `knn_exact`: identical indices
on every row whose k-th and (k+1)-th distances differ by more than 1e-6,
distances within 1e-6 (the two take other matmul shapes, which may round
a dot product by one ulp).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from fedrann_tpu.knn.ring import knn_exact_sharded as jax_sharded
from fedrann_tpu.parallel import mesh as jmesh
from fedrann_tpu_torch.knn import topk
from fedrann_tpu_torch.knn.ring import knn_exact_sharded
from fedrann_tpu_torch.parallel import mesh

CPU = torch.device("cpu")
CPU8 = [CPU] * 8
BF16_ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"


def _check_jax(idx, dist, idx_j, dist_j, n, precision):
    assert idx.shape == idx_j.shape and dist.shape == dist_j.shape
    np.testing.assert_allclose(
        dist, dist_j, atol=1e-4 if precision == "fp32" else BF16_ATOL)
    for r in range(n):
        assert len(set(idx[r]) & set(idx_j[r])) >= idx.shape[1] - 1, r
    assert idx.max() < n and idx.min() >= 0


def _check_own(idx, dist, e, k, precision, transfer="f32"):
    """Identical to the port's knn_exact where distances resolve the k-th
    neighbor from the (k+1)-th."""
    i1, d1 = topk.knn_exact(torch.from_numpy(e), k + 1, precision=precision,
                            transfer=transfer)
    resolved = d1[:, k] - d1[:, k - 1] > 1e-6
    assert resolved.mean() > 0.9
    np.testing.assert_array_equal(idx[resolved], i1[resolved, :k])
    atol = 1e-6 if transfer == "f32" else 1e-6 + 1 / topk.DIST_SCALE
    np.testing.assert_allclose(dist, d1[:, :k], atol=atol)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_sharded_matches_jax_and_knn_exact(strategy, precision):
    rng = np.random.default_rng(31)
    e = rng.normal(size=(200, 64)).astype(np.float32)  # 200 not divisible by 8
    e[11] = 0.0
    idx, dist = knn_exact_sharded(e, 10, mesh=mesh.make_mesh(devices=CPU8),
                                  strategy=strategy, precision=precision)
    idx_j, dist_j = jax_sharded(e, 10, mesh=jmesh.make_mesh(),
                                strategy=strategy, precision=precision)
    _check_jax(idx, dist, idx_j, dist_j, 200, precision)
    _check_own(idx, dist, e, 10, precision)
    # the zero row: distance exactly 1 to everything, ties to the lowest
    np.testing.assert_array_equal(idx[11], np.arange(10))
    assert np.all(dist[11] == 1.0)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_sharded_self_at_rank_zero(strategy):
    rng = np.random.default_rng(32)
    e = rng.normal(size=(64, 32)).astype(np.float32)
    idx, dist = knn_exact_sharded(e, 5, mesh=mesh.make_mesh(devices=CPU8),
                                  strategy=strategy, precision="fp32")
    idx_j, _ = jax_sharded(e, 5, mesh=jmesh.make_mesh(), strategy=strategy,
                           precision="fp32")
    np.testing.assert_array_equal(idx[:, 0], np.arange(64))
    np.testing.assert_array_equal(idx_j[:, 0], np.arange(64))
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=1e-5)


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_ring2d_matches_jax_and_knn_exact(n_hosts):
    """Ring-over-ring on every ("hosts", "data") factorization of eight
    entries: a re-tiling of the same search."""
    rng = np.random.default_rng(35)
    e = rng.normal(size=(200, 64)).astype(np.float32)
    idx, dist = knn_exact_sharded(
        e, 10, mesh=mesh.make_mesh_2d(n_hosts, CPU8), strategy="ring2d",
        precision="fp32")
    idx_j, dist_j = jax_sharded(e, 10, mesh=jmesh.make_mesh_2d(n_hosts),
                                strategy="ring2d", precision="fp32")
    _check_jax(idx, dist, idx_j, dist_j, 200, "fp32")
    _check_own(idx, dist, e, 10, "fp32")


def test_ring2d_requires_2d_mesh():
    rng = np.random.default_rng(36)
    e = rng.normal(size=(64, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="ring2d"):
        knn_exact_sharded(e, 4, mesh=mesh.make_mesh(devices=CPU8),
                          strategy="ring2d")
    with pytest.raises(ValueError, match="ring2d"):
        jax_sharded(e, 4, mesh=jmesh.make_mesh(), strategy="ring2d")


def test_mesh_smaller_than_devices():
    m = mesh.make_mesh(shape=(4,), devices=CPU8)
    assert m.size == 4 and m.shape == (4,)
    rng = np.random.default_rng(33)
    e = rng.normal(size=(50, 16)).astype(np.float32)
    idx, dist = knn_exact_sharded(e, 4, mesh=m, strategy="ring",
                                  precision="fp32")
    idx_j, dist_j = jax_sharded(e, 4, mesh=jmesh.make_mesh(shape=(4,)),
                                strategy="ring", precision="fp32")
    _check_jax(idx, dist, idx_j, dist_j, 50, "fp32")
    _check_own(idx, dist, e, 4, "fp32")


@pytest.mark.parametrize("strategy", ["ring", "allgather", "ring2d"])
def test_u16_transfer(strategy):
    """--knn-transfer u16 snaps the distances to the JAX grid."""
    rng = np.random.default_rng(37)
    e = rng.normal(size=(93, 24)).astype(np.float32)
    m = (mesh.make_mesh_2d(2, CPU8) if strategy == "ring2d"
         else mesh.make_mesh(devices=CPU8))
    jm = jmesh.make_mesh_2d(2) if strategy == "ring2d" else jmesh.make_mesh()
    idx, dist = knn_exact_sharded(e, 10, mesh=m, strategy=strategy,
                                  precision="fp32", transfer="u16")
    idx_j, dist_j = jax_sharded(e, 10, mesh=jm, strategy=strategy,
                                precision="fp32", transfer="u16")
    grid = dist * topk.DIST_SCALE
    np.testing.assert_allclose(grid, np.round(grid), atol=1e-3)
    _check_jax(idx, dist, idx_j, dist_j, 93, "fp32")
    _check_own(idx, dist, e, 10, "fp32", transfer="u16")


def test_tiles_and_counts():
    """Query and candidate tiles narrower than a block give the same
    result; the counts say how the call went."""
    rng = np.random.default_rng(38)
    e = torch.from_numpy(rng.normal(size=(130, 32)).astype(np.float32))
    m = mesh.make_mesh(devices=[CPU] * 3)
    wide = knn_exact_sharded(e, 7, mesh=m, precision="fp32")
    calls, merges = knn_exact_sharded.calls, knn_exact_sharded.merges
    tiled = knn_exact_sharded(e, 7, mesh=m, precision="fp32",
                              candidate_tile=16, query_tile=8)
    np.testing.assert_array_equal(tiled[0], wide[0])
    np.testing.assert_allclose(tiled[1], wide[1], atol=1e-6)
    assert knn_exact_sharded.calls == calls + 1
    assert knn_exact_sharded.devices == 3
    # 3 entries x 3 steps x 6 query tiles x 3 candidate tiles of a 44-row
    # block (16, 16, 12); the last block holds 42 real rows, the last
    # entry's queries 42 (6 tiles)
    assert knn_exact_sharded.merges - merges == 3 * 3 * 6 * 3


def test_pad_rows_to_multiple_matches_jax():
    rng = np.random.default_rng(39)
    a = rng.normal(size=(13, 5)).astype(np.float32)
    got, n = mesh.pad_rows_to_multiple(torch.from_numpy(a), 8)
    want, n_j = jmesh.pad_rows_to_multiple(a, 8)
    assert n == n_j == 13
    np.testing.assert_array_equal(got.numpy(), want)
    same, n = mesh.pad_rows_to_multiple(torch.from_numpy(a), 13)
    assert n == 13 and same.shape == (13, 5)


def test_make_mesh_truncates_as_jax():
    assert mesh.make_mesh(shape=(4,), devices=CPU8).size \
        == jmesh.make_mesh(shape=(4,)).devices.size == 4
    assert mesh.make_mesh(shape=(2, 4), devices=CPU8).size \
        == jmesh.make_mesh(shape=(2, 4)).devices.size == 8
    m = mesh.make_mesh_2d(2, CPU8)
    assert m.shape == jmesh.make_mesh_2d(2).devices.shape == (2, 4)
    assert m.axis_names == (mesh.HOST_AXIS, mesh.DATA_AXIS)


def test_make_mesh_2d_refuses_a_split_that_does_not_divide():
    with pytest.raises(ValueError, match="do not split over 3 hosts"):
        mesh.make_mesh_2d(3, CPU8)
    with pytest.raises(ValueError, match="do not split over 3 hosts"):
        jmesh.make_mesh_2d(3)


def test_make_mesh_needs_a_gpu_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh_2d(1)


def test_shard_rows_and_replicate():
    m = mesh.make_mesh(devices=[CPU] * 4)
    t = torch.arange(24).view(8, 3)
    shards = mesh.shard_rows(t, m)
    assert [s.tolist() for s in shards] == [t[i : i + 2].tolist()
                                            for i in range(0, 8, 2)]
    with pytest.raises(ValueError, match="pad them"):
        mesh.shard_rows(t[:7], m)
    copies = mesh.replicate(t, m)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
