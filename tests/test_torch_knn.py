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


def _keys_reference(run, q, c, index, k):
    """The merge by its definition, in numpy: every candidate's float64
    score of the float32 rows, the carry's keys decoded, all ordered by
    (score descending, index ascending) with the carry's EMPTY_KEY slots
    last: (scores, indices) of the best min(k, w + n)."""
    scores = (q.astype(np.float64) @ c.astype(np.float64).T)
    out = []
    for r in range(q.shape[0]):
        entries = [(-scores[r, j], int(index[j])) for j in range(len(index))]
        if run is not None:
            s, i = topk._decode_keys(torch.from_numpy(run[r]))
            entries += [(np.inf, 1 << 40) if key == topk.EMPTY_KEY
                        else (-float(s[j]), int(i[j]))
                        for j, key in enumerate(run[r])]
        out.append(sorted(entries)[:k])
    return out


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_merge_block_takes_bf16_rows(precision):
    """merge_block on bfloat16 rows (the out-of-core wire's) gives the
    keys of float32 rows holding the same values, at either precision,
    with a carry and the ids form."""
    rng = np.random.default_rng(21)
    q = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(37, 24)).astype(np.float32))).to(torch.bfloat16)
    c = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(90, 24)).astype(np.float32))).to(torch.bfloat16)
    c[5] = 0
    ids = torch.from_numpy(rng.permutation(1000)[:90].astype(np.int64))
    run = topk.merge_block(None, q.float(), c[:40].float(), ids[:40], 12,
                           precision)
    for form in (7, ids[40:]):
        want = topk.merge_block(run.clone(), q.float(), c[40:].float(), form,
                                12, precision)
        got = topk.merge_block(run.clone(), q, c[40:], form, 12, precision)
        assert got.shape == (37, 12)
        assert torch.equal(got, want)


def test_knn_exact_block_bf16_candidates_match_jax():
    """knn_exact_block with bfloat16 candidate rows (the queries a float32
    slice of them) against the JAX knn_exact_block on the same values at
    test_knn_bf16_tie_aware's tolerance."""
    rng = np.random.default_rng(15)
    e = rng.normal(size=(300, 64)).astype(np.float32)
    e[11] = 0
    en = topk.normalize_rows(torch.from_numpy(e)).to(torch.bfloat16)
    queries = en[100:180].float()
    idx_j, dist_j = jtopk.knn_exact_block(
        jnp.asarray(queries.numpy()), jnp.asarray(en.float().numpy()), 9,
        query_tile=32, candidate_tile=128, precision="bf16")
    idx, dist = topk.knn_exact_block(queries, en, 9, query_tile=32,
                                     candidate_tile=128, precision="bf16")
    np.testing.assert_allclose(dist, np.asarray(dist_j), atol=2e-3)
    agree = np.mean([len(set(a) & set(b)) / 9
                     for a, b in zip(idx, np.asarray(idx_j))])
    assert agree > 0.99, agree


def test_merge_block_ids_form_with_empty_carry_and_k_over_n():
    """The ids form over fewer candidates than k, into a carry whose slots
    are partly EMPTY_KEY: the best min(k, w + n) by (score, index), the
    unset slots last, as the definition orders them; a zero query row
    ties on every candidate and keeps the lowest indices."""
    rng = np.random.default_rng(8)
    q = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(6, 16)).astype(np.float32)))
    q[2] = 0
    first = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(3, 16)).astype(np.float32)))
    c = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(5, 16)).astype(np.float32)))
    ids = torch.tensor([40, 3, 17, 8, 25], dtype=torch.int64)
    run = torch.full((6, 6), topk.EMPTY_KEY, dtype=torch.int64)
    run[:, :3] = topk.merge_block(None, q, first, 100, 3, "fp32")
    got = topk.merge_block(run.clone(), q, c, ids, 20, "fp32")
    assert got.shape == (6, 11)
    assert bool((got[:, :8] != topk.EMPTY_KEY).all())
    assert bool((got[:, 8:] == topk.EMPTY_KEY).all())
    want = _keys_reference(run.numpy(), q.numpy(), c.numpy(), ids.numpy(),
                           11)
    scores, index = topk._decode_keys(got[:, :8])
    for r in range(6):
        assert [i for _, i in want[r][:8]] == index[r].tolist(), r
        np.testing.assert_allclose(scores[r].numpy(),
                                   [-s for s, _ in want[r][:8]], atol=1e-6)
    assert index[2].tolist() == [3, 8, 17, 25, 40, 100, 101, 102]


@pytest.mark.parametrize("sms", [16, 114, 132])
def test_k4_units_plan(sms):
    """K4's unit planner: at least one unit; no unit without candidates
    (each split range non-empty, at most one unit a tile); where the query
    blocks leave most of the card idle and n allows, enough units to keep
    90% of the SMs busy (or every block at K4_MAX_UNITS); a single unit
    when m and n are tiny."""
    for m in (1, 5, 128, 1000, 2048, 5000, 15000, 65536):
        for n in (1, 100, 1024, 15000, 65536, 262144, 1 << 20):
            for k in (1, 10, 50, 300):
                units = topk.k4_units(m, n, k, sms)
                tiles = -(-n // topk.K4_TILE)
                blocks = -(-m // topk.K4_ROWS)
                assert 1 <= units <= min(topk.K4_MAX_UNITS, tiles)
                splits = topk.k4_splits(n, units)
                assert splits[0][0] == 0 and splits[-1][1] == n
                assert all(lo < hi for lo, hi in splits)
                assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
                if 2 * blocks < sms and tiles >= topk.K4_MIN_TILES * sms:
                    assert blocks * units >= min(
                        0.9 * sms, blocks * topk.K4_MAX_UNITS), (m, n, k)
                if m <= topk.K4_ROWS and n <= 8 * topk.K4_TILE:
                    assert units == 1
    assert topk.k4_units(2048, 262144, 50, 132) * 16 >= 0.9 * 132


@pytest.mark.parametrize("units", [1, 2, 3, 7, 32])
@pytest.mark.parametrize("form", ["first", "ids_carry", "empty_carry_fp32"])
def test_merge_split_plain_matches_one_merge(units, form):
    """The plain split merge (each of k4_splits' candidate ranges merged
    alone, the first from the carry, then each row's best of the lists)
    equals one merge_block_plain over every candidate, bitwise, whatever
    the number of units: zero rows, the ids form, a carry with EMPTY_KEY
    slots and k past a split's candidates."""
    rng = np.random.default_rng(units)
    n, d, k = 4100, 24, 40 if form != "empty_carry_fp32" else 300
    q = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(37, d)).astype(np.float32)))
    c = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(n, d)).astype(np.float32)))
    q[3] = 0
    c[[0, 129, n - 1]] = 0
    precision = "fp32" if form.endswith("fp32") else "bf16"
    run, first = None, 11
    if form != "first":
        first = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int64))
        other = topk.normalize_rows(torch.from_numpy(
            rng.normal(size=(30, d)).astype(np.float32)))
        run = topk.merge_block_plain(None, q, other, 10 * n, 20, precision)
        if form.startswith("empty"):
            run[::2, 12:] = topk.EMPTY_KEY
    want = topk.merge_block_plain(None if run is None else run.clone(), q, c,
                                  first, k, precision)
    got = topk.merge_split_plain(None if run is None else run.clone(), q, c,
                                 first, k, precision, units)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 4, 8, 13, 40, 512])
def test_tma_rows_pad_for_both_forms(d, dtype):
    """The rows K4 reads by TMA (_tma_rows): the bf16 form rounds to
    bfloat16, the fp32 form keeps the rows' dtype; d is padded with zeros to
    tma_width (16 bytes of entries); rows already in that shape are taken
    as they are, and the padding leaves merge_block_plain's keys bitwise as
    they were."""
    rng = np.random.default_rng(d)
    x = topk.normalize_rows(torch.from_numpy(
        rng.normal(size=(21, d)).astype(np.float32))).to(dtype)
    for want in (torch.bfloat16, dtype):
        size = torch.empty((), dtype=want).element_size()
        width = topk.tma_width(d, size)
        assert width % (16 // size) == 0 and 0 <= width - d < 16 // size
        y = topk._tma_rows(x, want)
        assert y.dtype == want and y.shape == (21, width)
        assert (y is x) == (want == dtype and width == d)
        assert torch.equal(y[:, :d], x.to(want))
        assert not bool(y[:, d:].any())
        precision = "bf16" if want == torch.bfloat16 else "fp32"
        assert torch.equal(topk.merge_block_plain(None, y, y, 0, 5, precision),
                           topk.merge_block_plain(None, x, x, 0, 5, precision))
