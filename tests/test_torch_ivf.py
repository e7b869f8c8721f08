"""The port's IVF k-NN (fedrann_tpu_torch/knn/ivf.py, plain torch ops on
the CPU) against the JAX package's `fedrann_tpu/knn/ivf.py` on the same
numpy rows, made from seeds:

- integer tables bitwise: auto_clusters; the member and probe tables
  built from JAX's own assignment arrays, and from seeded ones at the
  edges of K11 (empty clusters, C = 1, N not a multiple of 128, p = C),
  alone and as the CPU search's steps run them (_members, _queries:
  counts and width included); the bucket form K11 writes on a card, by
  its plain version, expanded to JAX's tables;
- the segment sum (segment_sum_plain, K9's reference) bitwise
  jax.ops.segment_sum: random assignments, empty clusters, one cluster,
  bfloat16 rows widened as JAX widens them, chunks carried into one sum;
- the bucketing of the rows by cluster (_segments, the plain version of
  K9's counting sort, and its tile-by-tile replay) bitwise JAX's stable
  argsort and bincount prefix at its edge cases;
- k-means on blobs, with and without zero rows: assignments and counts
  equal JAX's, centroids within 1e-5; spill and probe lists equal JAX's,
  the zero rows' ties (the lowest cluster id first) included;
- the merge and its dedup on a crafted buffer with duplicates and unset
  slots, equal to JAX's;
- knn_ivf on blobs: recall against the port's knn_exact >= 0.98,
  distances within 1e-4 of a recompute, self at rank 0, rows sorted, no
  index twice in a row, neighbor agreement with JAX's knn_ivf >= 0.99;
  with every cluster probed, agreement with knn_exact >= 0.999; below the
  small-N valve, knn_exact's result exactly; unset slots -1 on both
  wires;
- read geometry (the oracle's embeddings of simulated reads): recall
  floors 0.72 / 0.85 at p = 8 / 16, C = 64, and within 0.02 of JAX's;
- knn_ivf_sharded over four CPU entries: knn_ivf's result at the rounded
  cluster count (agreement >= 0.999, recall >= knn_ivf's - 0.02), the
  padding and the small-N fallback to knn_exact_sharded;
- the CLI with --knn-method ivf (both transfers) against the exact CLI,
  >= 0.95.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu.knn import ivf as jivf
from fedrann_tpu_torch.knn import ivf
from fedrann_tpu_torch.knn.topk import EMPTY_KEY, keys_to_host, knn_exact
from fedrann_tpu_torch.parallel.mesh import make_mesh

from test_knn_ivf import _clustered_embeddings

CPU = torch.device("cpu")


def _recall(idx, ref):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(idx, ref)]))


def _unit(e):
    n = np.linalg.norm(e, axis=1, keepdims=True)
    return (e / np.where(n == 0, 1.0, n)).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    return _clustered_embeddings(6000, 64, 40, rng)


@pytest.mark.parametrize("n", [0, 1, 64, 4096, 6000, 65_536, 700_000,
                               10**9, 10**12])
def test_auto_clusters_matches_jax(n):
    assert ivf.auto_clusters(n) == jivf.auto_clusters(n)


@pytest.mark.parametrize("spill", [1, 2])
def test_member_and_probe_tables_bitwise(blobs, spill):
    """Tolerance: none (integer tables, from JAX's own assignments)."""
    en = jnp.asarray(_unit(blobs))
    cent, a, counts = jivf._kmeans(en, 64, 3)
    if spill > 1:
        a, counts = jivf._assign_spill(en, cent, spill)
    probes, qcounts = jivf._probe_lists(en, cent, 8)
    m = int(-(-int(np.asarray(counts).max()) // 128) * 128)
    qm = int(-(-int(np.asarray(qcounts).max()) // 128) * 128)
    want = np.asarray(jivf._member_table(a, counts, 64, m, spill=spill))
    got = ivf.member_table_plain(torch.from_numpy(np.asarray(a)),
                                 torch.from_numpy(np.asarray(counts)), 64,
                                 m, spill)
    np.testing.assert_array_equal(got.numpy(), want)
    qtab, stab = jivf._probe_tables(probes, qcounts, 64, qm)
    q_got, s_got = ivf.probe_tables_plain(
        torch.from_numpy(np.asarray(probes)),
        torch.from_numpy(np.asarray(qcounts)), 64, qm)
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(qtab))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(stab))


def _table_case(case: str, spill: int):
    """(assignments (N * spill,) int32, probes (N, p) int32, C) of a table
    edge case, from a seed: every odd cluster empty (N = 1,000); C = 1; N
    = 1,000 (not a multiple of 128) over C = 37; p = C = 8 (every row
    probes every cluster, in a row's own order)."""
    rng = np.random.default_rng(len(case) + spill)
    n, c, p = {"empty clusters": (1000, 64, 8), "C = 1": (700, 1, 1),
               "N = 1,000": (1000, 37, 8), "p = C": (500, 8, 8)}[case]
    a = rng.integers(0, c, (n, spill))
    probes = np.stack([rng.permutation(c)[:p] for _ in range(n)])
    if case == "empty clusters":
        a, probes = a - a % 2, probes - probes % 2
    return a.reshape(-1).astype(np.int32), probes.astype(np.int32), c


@pytest.mark.parametrize("spill", [1, 2])
@pytest.mark.parametrize("case", ["empty clusters", "C = 1", "N = 1,000",
                                  "p = C"])
def test_member_and_probe_tables_bitwise_edges(case, spill):
    """Tolerance: none (integer tables). The member table at spill 1 and
    2 and the probe tables of seeded assignments against JAX's
    _member_table and _probe_tables at the edges K11 (the tables' kernel)
    must keep: empty clusters, one cluster, N not a multiple of 128, p up
    to C; each table as wide as its largest cluster rounded up to 128."""
    a, probes, c = _table_case(case, spill)
    counts = np.bincount(a, minlength=c).astype(np.int32)
    qcounts = np.bincount(probes.ravel(), minlength=c).astype(np.int32)
    m, qm = (int(-(-int(x.max()) // 128) * 128) for x in (counts, qcounts))
    want = np.asarray(jivf._member_table(jnp.asarray(a), jnp.asarray(counts),
                                         c, m, spill=spill))
    got = ivf.member_table_plain(torch.from_numpy(a),
                                 torch.from_numpy(counts), c, m, spill)
    np.testing.assert_array_equal(got.numpy(), want)
    qtab, stab = jivf._probe_tables(jnp.asarray(probes), jnp.asarray(qcounts),
                                    c, qm)
    q_got, s_got = ivf.probe_tables_plain(torch.from_numpy(probes),
                                          torch.from_numpy(qcounts), c, qm)
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(qtab))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(stab))


@pytest.mark.parametrize("spill", [1, 2])
@pytest.mark.parametrize("case", ["empty clusters", "C = 1", "N = 1,000",
                                  "p = C"])
def test_members_and_queries_are_jax_tables(case, spill):
    """Tolerance: none (integer tables and counts). The IVF search's two
    table steps as it runs them, counts and width included (_members:
    the member table and the host's cluster counts; _queries: the probe
    tables and the host's query counts; each width the largest count
    rounded up to 128), against JAX's bincount, _member_table and
    _probe_tables at the same edge cases."""
    a, probes, c = _table_case(case, spill)
    counts = np.bincount(a, minlength=c)
    qcounts = np.bincount(probes.ravel(), minlength=c)
    m, qm = (int(-(-int(x.max()) // 128) * 128) for x in (counts, qcounts))
    member, counts_h = ivf._members(torch.from_numpy(a), c, spill)
    np.testing.assert_array_equal(counts_h, counts)
    np.testing.assert_array_equal(member.numpy(), np.asarray(
        jivf._member_table(jnp.asarray(a), jnp.asarray(counts), c, m,
                           spill=spill)))
    qtab, stab, qcounts_h = ivf._queries(torch.from_numpy(probes), c)
    np.testing.assert_array_equal(qcounts_h, qcounts)
    want_q, want_s = jivf._probe_tables(jnp.asarray(probes),
                                        jnp.asarray(qcounts), c, qm)
    np.testing.assert_array_equal(qtab.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(stab.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("spill", [1, 2])
@pytest.mark.parametrize("case", ["blobs", "empty clusters", "C = 1",
                                  "N = 1,000", "p = C"])
def test_plain_buckets_expand_to_jax_tables(blobs, case, spill):
    """Tolerance: none (integer tables). The bucket form K11 gives on a
    card, by its plain version (bucket_clusters_plain: the member side at
    div = spill, the probe side at div = p with the member side's
    bounds), expanded to dense tables at JAX's widths (expand_buckets,
    padded as JAX pads), against JAX's _member_table and _probe_tables;
    each side's bounds the prefix of JAX's counts. JAX's own k-means
    assignments on blobs, and the seeded edge cases."""
    if case == "blobs":
        en = jnp.asarray(_unit(blobs))
        cent, a, _ = jivf._kmeans(en, 64, 3)
        if spill > 1:
            a, _ = jivf._assign_spill(en, cent, spill)
        probes, _ = jivf._probe_lists(en, cent, 8)
        a, probes, c = np.asarray(a), np.asarray(probes), 64
    else:
        a, probes, c = _table_case(case, spill)
    n, p = probes.shape
    counts = np.bincount(a, minlength=c)
    qcounts = np.bincount(probes.ravel(), minlength=c)
    m, qm = (int(-(-int(x.max()) // 128) * 128) for x in (counts, qcounts))
    members = ivf.bucket_clusters_plain(torch.from_numpy(a), c, spill)
    queries = ivf.bucket_clusters_plain(torch.from_numpy(probes).reshape(-1),
                                        c, p, members.bounds)
    for b, want in ((members, counts), (queries, qcounts)):
        np.testing.assert_array_equal(b.bounds.numpy(), np.concatenate(
            [[0], np.cumsum(want)]))
    np.testing.assert_array_equal(
        ivf.expand_buckets(members.vals, members.bounds, m, n).numpy(),
        np.asarray(jivf._member_table(jnp.asarray(a), jnp.asarray(counts),
                                      c, m, spill=spill)))
    want_q, want_s = jivf._probe_tables(jnp.asarray(probes),
                                        jnp.asarray(qcounts), c, qm)
    np.testing.assert_array_equal(
        ivf.expand_buckets(queries.vals, queries.bounds, qm, n).numpy(),
        np.asarray(want_q))
    np.testing.assert_array_equal(
        ivf.expand_buckets(queries.slots, queries.bounds, qm, 0).numpy(),
        np.asarray(want_s))


SEGMENT_CASES = {"random": (5000, 64, 37), "empty clusters": (300, 100, 64),
                 "one cluster": (700, 16, 1), "one row": (1, 8, 8)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_sum_plain_is_jax_segment_sum(case, dtype):
    """Tolerance: none. Each cluster's rows added in row order from +0.0
    are jax.ops.segment_sum's bits on the CPU (as int32 views): random
    rows and assignments; 300 rows over 64 clusters of which the odd ones
    are empty, d = 100; every row in one cluster; one row. bfloat16 rows
    are widened to float32 first, as _kmeans's en.astype(jnp.float32).
    Rows streamed in chunks into one `out` give the whole pass's bits."""
    import jax

    n, d, c = SEGMENT_CASES[case]
    rng = np.random.default_rng(n + d + c)
    x = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.integers(0, c, n).astype(np.int32)
    if case == "empty clusters":
        a = a - a % 2
    rows_j = jnp.asarray(x)
    if dtype == "bfloat16":
        rows_j = rows_j.astype(jnp.bfloat16)
    want = np.asarray(jax.ops.segment_sum(rows_j.astype(jnp.float32),
                                          jnp.asarray(a), num_segments=c))
    rows = torch.from_numpy(np.asarray(rows_j.astype(jnp.float32)).copy())
    rows = rows.to(getattr(torch, dtype))
    got = ivf.segment_sum_plain(rows, torch.from_numpy(a), c)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert torch.equal(ivf._segment_sum(rows, torch.from_numpy(a), c), got)
    out = torch.zeros((c, d))
    for r0 in range(0, n, 77):
        ivf._segment_sum(rows[r0 : r0 + 77],
                         torch.from_numpy(a[r0 : r0 + 77]), c, out)
    assert torch.equal(out.view(torch.int32), got.view(torch.int32))


def _bucket_case(case):
    """(assignments (N,) int32, C) of a bucketing edge case, from a seed."""
    rng = np.random.default_rng(len(case))
    if case == "N = 0":
        return np.zeros(0, np.int32), 8
    if case == "N = 1":
        return np.array([5], np.int32), 8
    if case == "one cluster holding every row":
        return np.zeros(3000, np.int32), 16
    if case == "empty clusters":
        a = rng.integers(0, 64, 3000)
        return (a - a % 2).astype(np.int32), 64
    if case == "C = 65,536":
        return rng.integers(0, 65_536, 3000).astype(np.int32), 65_536
    if case == "a tile boundary mid-cluster":
        # runs of 300 rows of one cluster, one across each 1,024-row tile
        # boundary, among random rows
        a = rng.integers(0, 12, 4 * ivf.K9_TILE + 77)
        for t in range(1, 5):
            a[t * ivf.K9_TILE - 150 : t * ivf.K9_TILE + 150] = t % 3
        return a.astype(np.int32), 12
    return rng.integers(0, 37, 5000).astype(np.int32), 37


BUCKET_CASES = ["N = 0", "N = 1", "one cluster holding every row",
                "empty clusters", "C = 65,536", "a tile boundary mid-cluster",
                "random"]


@pytest.mark.parametrize("case", BUCKET_CASES)
def test_segments_are_jax_stable_argsort_and_bincount(case):
    """Tolerance: none. _segments (the plain version of K9's bucketing)
    gives the JAX package's jnp.argsort(a, stable=True) as order and the
    prefix of jnp.bincount(a, length=C) as bounds, as _member_table
    builds them, at every bucketing edge case."""
    a, c = _bucket_case(case)
    want_order = np.asarray(jnp.argsort(jnp.asarray(a), stable=True))
    counts = np.asarray(jnp.bincount(jnp.asarray(a), length=c))
    want_bounds = np.concatenate([[0], np.cumsum(counts)])
    order, bounds = ivf._segments(torch.from_numpy(a), c)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(bounds.numpy(), want_bounds)


@pytest.mark.parametrize("case", BUCKET_CASES)
def test_k9_bucketing_replay_is_segments(case):
    """Tolerance: none. K9's counting sort replayed tile by tile
    (_k9_replay: per-tile counts, their prefix over the tiles, each tile's
    rows placed in row order) gives _segments' (order, bounds), and its
    tiles follow k9_tiles' limits."""
    a, c = _bucket_case(case)
    order, bounds = ivf._k9_replay(torch.from_numpy(a), c)
    want_order, want_bounds = ivf._segments(torch.from_numpy(a), c)
    assert torch.equal(order, want_order)
    assert torch.equal(bounds, want_bounds)
    tile, n_tiles = ivf.k9_tiles(len(a), c)
    assert tile % 32 == 0 and n_tiles * tile >= len(a)
    assert n_tiles <= ivf.K9_MAX_TILES
    assert n_tiles * c <= max(ivf.K9_MAX_CELLS, c)


@pytest.mark.parametrize("zero_rows", [False, True])
def test_kmeans_spill_and_probes_match_jax(blobs, zero_rows):
    """Centroids within 1e-5 (float32 sums in another order); assignments,
    counts, spill and probe lists equal, zero rows' ties included."""
    e = blobs.copy()
    if zero_rows:
        e[::37] = 0.0
    en = _unit(e)
    cent_j, a_j, counts_j = jivf._kmeans(jnp.asarray(en), 64, 3)
    cent = ivf._kmeans(torch.from_numpy(en), 64, 3)
    np.testing.assert_allclose(cent.numpy(), np.asarray(cent_j), rtol=0,
                               atol=1e-5)
    a = ivf._top_clusters(torch.from_numpy(en), cent, 1)[:, 0]
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(torch.bincount(a, minlength=64).numpy(),
                                  np.asarray(counts_j))
    # spill and probe lists from the same (JAX's) centroids
    flat_j, _ = jivf._assign_spill(jnp.asarray(en), cent_j, 2)
    probes_j, _ = jivf._probe_lists(jnp.asarray(en), cent_j, 8)
    top = ivf._top_clusters(torch.from_numpy(en),
                            torch.from_numpy(np.asarray(cent_j)), 8)
    np.testing.assert_array_equal(top[:, :2].reshape(-1).numpy(),
                                  np.asarray(flat_j))
    np.testing.assert_array_equal(top.numpy(), np.asarray(probes_j))
    if zero_rows:  # every centroid scores 0: the lowest ids, in order
        np.testing.assert_array_equal(top[::37].numpy(),
                                      np.tile(np.arange(8), (len(e[::37]),
                                                             1)))


def _keys(dist, idx):
    """JAX's (dist, idx) merge buffers as the port's int64 keys: score 1 -
    dist (exact for these dists), unset slots (idx < 0) EMPTY_KEY."""
    from fedrann_tpu_torch.knn.topk import _order_keys

    s = torch.from_numpy(1.0 - dist).contiguous()
    ids = torch.from_numpy(np.where(idx < 0, 0, idx).astype(np.int64))
    keys = _order_keys(s.clone(), ids)
    return keys.masked_fill_(torch.from_numpy(idx < 0), EMPTY_KEY)


@pytest.mark.parametrize("spill", [1, 2])
def test_merge_buffers_match_jax(spill):
    """A crafted (N, p, kk) buffer with duplicate indices (same distance;
    spill 2), equal distances across indices (spill 2, where JAX's merge
    sorts by index first) and unset (inf, -1) slots: the port's merge
    equals JAX's _merge_buffers exactly (distances on a 1/1024 grid, so
    1 - (1 - d) == d)."""
    rng = np.random.default_rng(5)
    n, p, kk, k = 300, 4, 6, 10
    dist = rng.integers(0, 2048, size=(n, p, kk)).astype(np.float32) / 1024
    idx = rng.integers(0, 40, size=(n, p, kk)).astype(np.int32)
    if spill == 1:  # distinct indices a row, as disjoint member lists
        # give, at distinct distances: JAX's top_k breaks a distance tie
        # by buffer position, the port by the lowest index (knn_exact's)
        idx = np.stack([rng.permutation(400)[: p * kk].reshape(p, kk)
                        for _ in range(n)]).astype(np.int32)
        dist = np.stack([rng.permutation(2048)[: p * kk].reshape(p, kk)
                         for _ in range(n)]).astype(np.float32) / 1024
    else:  # a duplicate carries its index's distance
        first = {}
        for r in range(n):
            first.clear()
            for j in np.ndindex(p, kk):
                dist[(r, *j)] = first.setdefault(idx[(r, *j)],
                                                 dist[(r, *j)])
    unset = rng.random((n, p, kk)) < 0.3
    unset[:5] = True  # rows with no candidate at all
    dist[unset], idx[unset] = np.inf, -1
    want_d, want_i = jivf._merge_buffers(
        jnp.asarray(np.concatenate([dist, np.full((1, p, kk), np.inf,
                                                  np.float32)])),
        jnp.asarray(np.concatenate([idx, np.full((1, p, kk), -1,
                                                 np.int32)])),
        n, k, spill)
    keys = ivf._merge_buffers(_keys(dist, idx), k, spill)
    got_i, got_d = keys_to_host(keys, "f32", 400)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


def test_dedup_keeps_the_higher_score():
    """Two copies of one index whose scores differ in the last bit (two
    products of different shapes): the higher-scoring copy stays, the
    other slot goes to the next index."""
    s = torch.tensor([[0.5, np.nextafter(np.float32(0.5), np.float32(0)),
                       0.25]], dtype=torch.float32)
    from fedrann_tpu_torch.knn.topk import _order_keys

    keys = _order_keys(s, torch.tensor([[7, 7, 3]]))
    buf = keys.reshape(1, 3, 1)
    idx, dist = keys_to_host(ivf._merge_buffers(buf, 3, 2), "f32", 10)
    np.testing.assert_array_equal(idx, [[7, 3, -1]])
    assert dist[0, 0] == np.float32(0.5) and dist[0, 2] == np.inf


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_knn_ivf_on_blobs(blobs, precision):
    """Recall >= 0.98 against knn_exact, every distance within 1e-4 of a
    recompute, self at rank 0, sorted rows, no index twice in a row;
    neighbor agreement with JAX's knn_ivf >= 0.99."""
    e = torch.from_numpy(blobs)
    k = 20
    calls = ivf.knn_ivf.calls, ivf.knn_ivf.exact_fallbacks
    idx, dist = ivf.knn_ivf(e, k, n_clusters=64, n_probes=8,
                            precision=precision)
    assert (ivf.knn_ivf.calls, ivf.knn_ivf.exact_fallbacks) == (
        calls[0] + 1, calls[1])
    assert ivf.knn_ivf.last["clusters"] == 64
    ref, _ = knn_exact(e, k, precision=precision)
    assert _recall(idx, ref) >= 0.98
    en = _unit(blobs)
    true = 1.0 - np.einsum("rd,rkd->rk", en, en[idx])
    assert np.abs(dist - true).max() < (1e-4 if precision == "fp32"
                                        else 1e-2)
    assert np.array_equal(idx[:, 0], np.arange(len(blobs)))
    assert (np.diff(dist, axis=1) >= 0).all()
    assert all(len(set(r)) == k for r in idx)
    j_idx, _ = jivf.knn_ivf(blobs, k, n_clusters=64, n_probes=8,
                            precision=precision)
    assert _recall(idx, np.asarray(j_idx)) >= 0.99


def test_all_probes_match_exact(blobs):
    """p = C: every cluster rescored, so the neighbor sets are knn_exact's
    (agreement >= 0.999; ties aside)."""
    e = torch.from_numpy(blobs[:3000])
    idx, dist = ivf.knn_ivf(e, 10, n_clusters=16, n_probes=16,
                            precision="fp32")
    ref_i, ref_d = knn_exact(e, 10, precision="fp32")
    assert _recall(idx, ref_i) >= 0.999
    np.testing.assert_allclose(dist, ref_d, rtol=0, atol=1e-5)


def test_small_n_falls_back_to_exact():
    rng = np.random.default_rng(7)
    e = torch.from_numpy(rng.normal(size=(300, 32)).astype(np.float32))
    before = ivf.knn_ivf.exact_fallbacks
    for transfer in ("f32", "u16"):
        idx, dist = ivf.knn_ivf(e, 10, precision="fp32", transfer=transfer)
        ref_i, ref_d = knn_exact(e, 10, precision="fp32", transfer=transfer)
        np.testing.assert_array_equal(idx, ref_i)
        np.testing.assert_array_equal(dist, ref_d)
    assert ivf.knn_ivf.exact_fallbacks == before + 2


def test_unset_slots_survive_both_wires():
    """p = spill = 1 over many small clusters: a query's cluster holds
    fewer than k rows, so slots stay unset: -1 at distance inf on the f32
    wire and 2.0 on the u16 grid, at the same places as JAX's f32 result
    (whose u16 wire clips -1 to 0)."""
    rng = np.random.default_rng(3)
    e = _clustered_embeddings(640, 16, 40, rng)
    kw = dict(n_clusters=160, n_probes=1, spill=1, precision="fp32")
    want_i, want_d = jivf.knn_ivf(e, 12, **kw)
    want_i = np.asarray(want_i)
    assert (want_i < 0).any()
    for transfer in ("f32", "u16"):
        idx, dist = ivf.knn_ivf(torch.from_numpy(e), 12, transfer=transfer,
                                **kw)
        np.testing.assert_array_equal(idx < 0, want_i < 0)
        assert (dist[idx < 0] == (np.inf if transfer == "f32" else 2.0)
                ).all()
        assert _recall(np.where(idx < 0, -1 - np.arange(12), idx),
                       np.where(want_i < 0, -1 - np.arange(12), want_i)
                       ) >= 0.99


@pytest.fixture(scope="module")
def read_rows():
    """The oracle's (2R, 128) embeddings of simulated reads (the shape of
    tests/test_knn_ivf_sharded.py's read-geometry test) and knn_exact's
    top 20 on them."""
    from fedrann_tpu_torch import oracle
    from fedrann_tpu_torch.sim import simulate_reads

    sim = simulate_reads(genome_length=200_000, coverage=8,
                         mean_read_length=2000, error_rate=0.05, seed=5)
    lib = oracle.build_library(sim.sequences, 15, 2, 0.1, 602)
    rows = oracle.feature_rows(sim.sequences, 15, lib)
    emb = oracle.embed(rows, lib, 128, 2094).astype(np.float32)
    ref, _ = knn_exact(torch.from_numpy(emb), 20, precision="fp32")
    return emb, ref


@pytest.mark.parametrize("probes,floor", [(8, 0.72), (16, 0.85)])
def test_recall_on_read_geometry(read_rows, probes, floor):
    """Recall against exact above JAX's floors, and within 0.02 of JAX's
    knn_ivf on the same rows."""
    emb, ref = read_rows
    idx, _ = ivf.knn_ivf(torch.from_numpy(emb), 20, n_clusters=64,
                         n_probes=probes, precision="fp32")
    j_idx, _ = jivf.knn_ivf(emb, 20, n_clusters=64, n_probes=probes,
                            precision="fp32")
    r, r_jax = _recall(idx, ref), _recall(np.asarray(j_idx), ref)
    assert r >= floor, r
    assert abs(r - r_jax) <= 0.02, (r, r_jax)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(devices=[CPU] * 4)


def test_sharded_is_knn_ivf_at_the_rounded_cluster_count(read_rows, mesh4):
    """C = 62 rounds up to 64 over 4 entries; the sharded search is
    knn_ivf's at C = 64 (agreement >= 0.999, recall >= knn_ivf's - 0.02,
    distances within 1e-5)."""
    emb, ref = read_rows
    e = torch.from_numpy(emb)
    before = ivf.knn_ivf_sharded.calls
    idx_s, dist_s = ivf.knn_ivf_sharded(e, 20, mesh=mesh4, n_clusters=62,
                                        n_probes=8, precision="fp32")
    assert ivf.knn_ivf_sharded.calls == before + 1
    assert ivf.knn_ivf_sharded.last["clusters"] == 64
    idx, dist = ivf.knn_ivf(e, 20, n_clusters=64, n_probes=8,
                            precision="fp32")
    assert _recall(idx_s, idx) >= 0.999
    assert _recall(idx_s, ref) >= _recall(idx, ref) - 0.02
    np.testing.assert_allclose(dist_s, dist, rtol=0, atol=1e-5)


def test_sharded_pads_and_keeps_self(mesh4):
    """5,003 rows over 4 entries (a ragged last block): self at rank 0,
    indices in range, sorted rows."""
    rng = np.random.default_rng(13)
    e = _clustered_embeddings(5003, 32, 25, rng)
    idx, dist = ivf.knn_ivf_sharded(torch.from_numpy(e), 8, mesh=mesh4,
                                    n_clusters=32, n_probes=4,
                                    precision="fp32")
    assert idx.shape == (5003, 8)
    assert np.array_equal(idx[:, 0], np.arange(5003))
    assert np.allclose(dist[:, 0], 0.0, atol=1e-5)
    assert idx.min() >= 0 and idx.max() < 5003
    assert (np.diff(dist, axis=1) >= 0).all()


def test_sharded_small_n_falls_back_to_sharded_exact(mesh4):
    from fedrann_tpu_torch.knn.ring import knn_exact_sharded

    rng = np.random.default_rng(7)
    e = torch.from_numpy(rng.normal(size=(300, 32)).astype(np.float32))
    before = (ivf.knn_ivf_sharded.exact_fallbacks, knn_exact_sharded.calls)
    idx, dist = ivf.knn_ivf_sharded(e, 10, mesh=mesh4, precision="fp32")
    assert (ivf.knn_ivf_sharded.exact_fallbacks,
            knn_exact_sharded.calls) == (before[0] + 1, before[1] + 1)
    ref_i, ref_d = knn_exact(e, 10, precision="fp32")
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(dist, ref_d, rtol=0, atol=1e-6)


def test_the_four_card_cells_search_over_four_entries_is_correct(mesh4):
    """pipeline.search with ont-grch38-chr1-5's flags and --knn-sharded
    always over four CPU entries, on portbench.gen rows of a 0.8 Mb genome
    at that configuration's density (4,800 rows, past the IVF's valve):
    one knn_ivf_sharded call and one knn_ivf call, not an exact fallback;
    the record's four entries hold every query row and every real pair
    score; the plain reference (portbench/reference/knn.py) judges every
    answer within the cell's limits."""
    from fedrann_tpu_torch import pipeline
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.metrics import StageMetrics
    from portbench.gen import Dataset, Features, make_read_set
    from portbench.reference import knn as ref
    from portbench.tests.conftest import small_cell

    cell = small_cell("ont-grch38-chr1-5.ivf-sharded", 800_000)
    config = config_from_args(["-i", "reads.fa", "-o", "out", *cell.flags,
                               "--knn-sharded", "always"])
    ft = Features(config.kmer_size, config.kmer_sample_fraction,
                  config.kmer_min_multiplicity, config.embedding_dimension,
                  config.projection_density)
    rows = make_read_set(Dataset(**cell.config["dataset"]), ft,
                         2**33 + 26, CPU).rows
    n = rows.shape[0]
    before = (ivf.knn_ivf.calls, ivf.knn_ivf.exact_fallbacks,
              ivf.knn_ivf_sharded.calls)
    idx, dist = pipeline.search(config, rows, False, True,
                                list(mesh4.devices), CPU, StageMetrics(CPU))
    assert (ivf.knn_ivf.calls, ivf.knn_ivf.exact_fallbacks,
            ivf.knn_ivf_sharded.calls) == (before[0] + 1, before[1],
                                           before[2] + 1)
    last = ivf.knn_ivf.last
    assert ivf.knn_ivf_sharded.last is last
    assert (n, last["clusters"], last["entries"]) == (4800, 128, 4)
    assert len(last["entry_rows"]) == 4 and sum(last["entry_rows"]) == n
    assert sum(last["entry_pairs"]) == last["real_pair_scores"]
    checks = ref.judge(rows, np.arange(n), idx, dist, config.n_neighbors,
                       cell.limits)
    assert set(checks) == set(cell.limits)
    assert all(checks[x] <= cell.limits[x] for x in checks), checks


@pytest.mark.parametrize("transfer", ["u16", "f32"])
def test_pipeline_ivf_matches_exact_neighbors(tmp_path, transfer):
    """The CLI's run with --knn-method ivf (C = 8, p = 6) against the
    exact run on the same reads (tests/test_knn_ivf.py's setting):
    neighbor agreement >= 0.95; knn_ivf ran once, past its valve."""
    from fedrann_tpu_torch.cli import config_from_args
    from fedrann_tpu_torch.pipeline import run_pipeline
    from fedrann_tpu_torch.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=200_000, coverage=8,
                         mean_read_length=4000, error_rate=0.03, seed=5)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)

    def run(extra):
        return run_pipeline(config_from_args([
            "-i", fasta, "-o", str(tmp_path / ("out_" + extra[1])),
            "-k", "15", "--kmer-sample-fraction", "0.05",
            "--kmer-min-multiplicity", "2", "-n", "128",
            "--nndescent-n-neighbors", "10", "--seed", "602",
            "--knn-transfer", transfer, *extra]), CPU)

    exact = run(["--knn-method", "exact"])
    before = ivf.knn_ivf.calls, ivf.knn_ivf.exact_fallbacks
    got = run(["--knn-method", "ivf", "--knn-ivf-clusters", "8",
               "--knn-ivf-probes", "6"])
    assert (ivf.knn_ivf.calls, ivf.knn_ivf.exact_fallbacks) == (
        before[0] + 1, before[1])
    assert _recall(got.neighbor_indices, exact.neighbor_indices) >= 0.95
    # the knn's work is JAX's: 2 N^2 d scaled by p / C
    n, d = got.embeddings.shape
    assert got.metrics["knn"]["flops"] == pytest.approx(
        2.0 * n * n * d * 6 / 8)
