"""The IVF search's device stages (fedrann_tpu_torch/knn/ivf.py): the
rescore (K6, csrc/ivf_rescore.cu `fk_ivf_rescore`, and its plain version
rescore_plain), the dedup merge (K7, `fk_ivf_merge`, and
merge_buffers_plain) and the cluster ranking (_top_clusters: K4 on the
card, top_clusters_plain on the CPU).

On the CPU, against the JAX package's `fedrann_tpu/knn/ivf.py` on the
same numpy rows and tables:
- rescore_plain's (query, probe slot) buffer against JAX's
  _rescore_group + _scatter_group over JAX's own member and probe tables,
  bitwise on grid rows (entries k / 64: exact in bfloat16, every product
  and sum exact in float32) at both precisions and spill 1 and 2, and on
  blobs within 1e-6 a distance at index-set agreement >= 0.999;
- _top_clusters on CPU tensors bitwise JAX's _assign_spill and
  _probe_lists from the same centroids;
- the dispatch: CPU tensors reach the plain versions, and the kernels'
  wrappers refuse them;
- the vectorized size-class plan (_rescore_plan) against the loop over
  clusters, and K6's work list from the buckets' bounds
  (bucket_units_plain) against the host's former list (rescore_units)
  as rows;
- the rows K6 gathers (topk._tma_rows, as rescore_clusters makes them):
  one copy of the search's dtype, 16-byte aligned, zero columns out to a
  16-byte pitch only where the width needs them;
- K6's and K7's device algorithms replayed on tensors (ivf._k6_replay:
  the first selection's bisection, the later tiles' offers, overflow
  rounds and merges; ivf._k7_replay: the merge network, the dedup of
  exact copies and the exact finish) bitwise rescore_plain and
  merge_buffers_plain: ties, rows >= n_real, members fewer than W, W in
  {1, 50, 64, 100}, a cluster whose later tiles beat every earlier key
  (every overflow round), K6's units in any order, lists whose indices
  recur at other scores.

The `cuda` tests (skipped without a card) hold each kernel against its
plain version on the card: K6 bitwise on grid rows (d = 512, and 500 and
130, whose rows go in as a padded copy) and at the edge cases
(a 1-member cluster, one past a tile, k past the members, sentinel rows,
unprobed and empty clusters, C = 8, a query row offset; W = 1, 50, 64 and
100; a cluster past the first selection's 256 members, and one that
overflows its survivor slots), to an index-set
agreement >= 0.999 and scores within 2e-6 on real rows, two launches
byte-identical (at d = 500 also bitwise K6 on the rows padded to 512 by
hand); K6 on K11's work list (made on the card) bitwise K6 on
the host's (ivf.host_units); knn_ivf_sharded over every card bitwise
knn_ivf on one (two cards or more); knn_ivf with no synchronizing call
between the k-means and K6's launch; K7 bitwise at spill 1, 2 and 3 on K6's own buffers and on
sorted lists whose indices recur at other scores; K4 as the cluster
ranking at agreement >= 0.999, ties to the lower of two equal centroids;
knn_ivf through K4, K6 and K7 with no plain version reached, its padded
launches and K6's row pitch in its record; the kernels
on the last card's tensors. This file imports JAX only inside the CPU
tests, so on a machine with a card and no JAX
    python -m pytest --noconftest -q -m cuda tests/test_torch_ivf_rescore.py
runs the `cuda` tests alone.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedrann_tpu_torch.knn import ivf
from fedrann_tpu_torch.knn.topk import (
    EMPTY_KEY,
    _decode_keys,
    _order_keys,
    _tma_rows,
    tma_width,
)

CPU = torch.device("cpu")


@pytest.fixture
def jivf():
    """The JAX package's IVF module (imported here, not at the top: the
    `cuda` tests of this file run where JAX is not installed)."""
    from fedrann_tpu.knn import ivf as module

    return module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a CUDA kernel with its "
                    "plain version")
    return torch.device("cuda")


@pytest.fixture
def last_card(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices: launches each kernel on the "
                    "last card while cuda:0 is current")
    torch.cuda.set_device(0)
    return torch.device("cuda", n - 1)


def _grid(rng, n, d):
    """Rows of entries k / 64, |k| <= 8 (see the module docstring)."""
    return (rng.integers(-8, 9, size=(n, d)) / 64).astype(np.float32)


def _blobs(n, d, c, rng):
    centers = rng.standard_normal((c, d)).astype(np.float32)
    rows = centers[rng.integers(0, c, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _case(en_pad, n_real, member, counts_h, probes, k, first=0):
    """The tables and plan of one rescore over torch tensors on the
    device of en_pad: what rescore_plain takes (the dense tables), and
    what rescore_clusters and _k6_replay take (the member and probe
    Buckets: K11's on a card, bucket_clusters_plain's on the CPU)."""
    c = member.shape[0]
    qtab, stab, qcounts_h = ivf._queries(probes, c)
    members = ivf.table_buckets(member, counts_h)
    bucket = ivf.bucket_clusters if probes.is_cuda \
        else ivf.bucket_clusters_plain
    queries = bucket(probes.reshape(-1).contiguous(), c, probes.shape[1],
                     members.bounds)
    return dict(en_pad=en_pad, n_real=n_real, member=member,
                counts_h=np.asarray(counts_h), qtab=qtab, stab=stab,
                qcounts_h=qcounts_h, first=first, nq=probes.shape[0],
                p=probes.shape[1], k=k, kk_g=min(k, member.shape[1]),
                groups=ivf._rescore_plan(np.asarray(counts_h), qcounts_h,
                                         qtab.shape[1], member.shape[1]),
                members=members, queries=queries)


def _plain(case):
    return ivf.rescore_plain(case["en_pad"], case["n_real"], case["member"],
                             case["qtab"], case["stab"], case["groups"],
                             case["first"], case["nq"], case["p"],
                             case["k"], case["kk_g"])


def _kernel(case, precision, queries=None):
    return ivf.rescore_clusters(
        case["en_pad"], case["n_real"], case["members"],
        case["queries"] if queries is None else queries, case["first"],
        case["nq"], case["p"], case["kk_g"], precision)


def _ivf_case(rows, c, p, spill, k, device=CPU):
    """knn_ivf's tables over rows (N, d) float32 (taken as the search
    scores them: a zero row appended), on `device`."""
    n = rows.shape[0]
    en_pad = torch.cat([torch.from_numpy(rows), torch.zeros(
        (1, rows.shape[1]))]).to(device)
    _, top = ivf._tables(en_pad[:n], c, 3, spill, p)
    member, counts_h = ivf._members(top[:, :spill].reshape(-1), c, spill)
    return _case(en_pad, n, member, counts_h, top[:, :p].contiguous(), k)


def _jax_buffer(jivf, rows, precision, c, p, spill, k):
    """JAX's (N, p, kk_g) rescore buffer over its own tables of `rows`,
    driven as `_ivf_search_grouped` drives _rescore_group and
    _scatter_group, as the port's keys (score 1 - dist; an inf distance
    or a -1 index EMPTY_KEY), and those tables."""
    import jax.numpy as jnp

    n, d = rows.shape
    en = jnp.asarray(rows)
    cent, _, _ = jivf._kmeans(en, c, 3)
    a, counts = jivf._assign_spill(en, cent, spill)
    probes, qcounts = jivf._probe_lists(en, cent, p)
    counts_h, qcounts_h = np.asarray(counts), np.asarray(qcounts)
    m = ivf._ceil128(counts_h.max())
    qm = ivf._ceil128(qcounts_h.max())
    member = jivf._member_table(a, counts, c, m, spill=spill)
    qtab, stab = jivf._probe_tables(probes, qcounts, c, qm)
    en_pad = jnp.concatenate([en, jnp.zeros((1, d), en.dtype)])
    if precision == "bf16":
        en_pad = en_pad.astype(jnp.bfloat16)
    kk_g = min(k, m)
    buf_d = jnp.full((n + 1, p, kk_g), jnp.inf, jnp.float32)
    buf_i = jnp.full((n + 1, p, kk_g), -1, jnp.int32)
    for (qcls, mcls), cl in sorted(ivf._rescore_plan(
            counts_h, qcounts_h, qm, m).items()):
        sel = jnp.asarray(np.asarray(cl, np.int32))
        qt_g, st_g = qtab[sel][:, :qcls], stab[sel][:, :qcls]
        dist_g, idx_g = jivf._rescore_group(
            en_pad, member[sel][:, :mcls], qt_g, jnp.int32(n),
            min(k, mcls), "exact")
        buf_d, buf_i = jivf._scatter_group(buf_d, buf_i, qt_g, st_g,
                                           dist_g, idx_g)
    dist, idx = np.asarray(buf_d)[:n], np.asarray(buf_i)[:n]
    unset = np.isinf(dist) | (idx < 0)
    keys = _order_keys(torch.from_numpy(np.where(unset, 0.0, 1.0 - dist)
                                        .astype(np.float32)),
                       torch.from_numpy(np.where(unset, 0, idx)
                                        .astype(np.int64)))
    keys.masked_fill_(torch.from_numpy(unset), EMPTY_KEY)
    tables = {name: torch.from_numpy(np.array(t)) for name, t in (
        ("member", member), ("probes", probes))}
    return keys, tables, counts_h


def _port_buffer(rows, tables, counts_h, k):
    n = rows.shape[0]
    en_pad = torch.cat([torch.from_numpy(rows),
                        torch.zeros((1, rows.shape[1]))])
    case = _case(en_pad, n, tables["member"], counts_h, tables["probes"], k)
    return _plain(case)


def _set_agreement(got, want):
    """The share of got's set entries (not EMPTY_KEY) whose index the
    same list of want holds, and the largest score difference of such a
    pair; got, want (lists, w) int64 keys."""
    gs, gi = _decode_keys(got)
    ws, wi = _decode_keys(want)
    ge, we = got == EMPTY_KEY, want == EMPTY_KEY
    eq = (gi[:, :, None] == wi[:, None, :]) & ~ge[:, :, None] \
        & ~we[:, None, :]
    err = float((gs[:, :, None] - ws[:, None, :]).abs()[eq].max()) \
        if bool(eq.any()) else 0.0
    return float(eq.any(2).sum()) / max(int((~ge).sum()), 1), err


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("spill", [1, 2])
def test_rescore_plain_matches_jax_on_grid_rows(jivf, precision, spill):
    """Tolerance: none. Grid rows make every score exact in both
    packages, and equal scores go to the lowest index in both (JAX's
    top_k by member position, which is row order)."""
    rows = _grid(np.random.default_rng(3 + spill), 3000, 64)
    want, tables, counts_h = _jax_buffer(jivf, rows, precision, 32, 4,
                                         spill, 20)
    got = _port_buffer(rows, tables, counts_h, 20)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_rescore_plain_matches_jax_on_blobs(jivf, precision):
    """Real rows (unit blobs, bf16-rounded at bf16): the same unset
    slots, index-set agreement >= 0.999 over the (query, slot) lists and
    every shared pair's distance within 1e-6 (float32 sums in another
    order)."""
    rows = _blobs(4000, 64, 30, np.random.default_rng(8))
    if precision == "bf16":
        rows = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    want, tables, counts_h = _jax_buffer(jivf, rows, precision, 32, 6, 2,
                                         15)
    got = _port_buffer(rows, tables, counts_h, 15)
    w = got.shape[-1]
    assert torch.equal(got == EMPTY_KEY, want == EMPTY_KEY)
    agree, err = _set_agreement(got.reshape(-1, w), want.reshape(-1, w))
    assert agree >= 0.999 and err <= 1e-6, (agree, err)


@pytest.mark.parametrize("zero_rows", [False, True])
def test_top_clusters_on_cpu_matches_jax(jivf, zero_rows):
    """_top_clusters on CPU tensors (top_clusters_plain) against JAX's
    _assign_spill and _probe_lists from the same centroids: equal, the
    zero rows' ties (every centroid scores 0) to the lowest ids."""
    import jax.numpy as jnp

    rows = _blobs(3000, 32, 20, np.random.default_rng(21))
    if zero_rows:
        rows[::29] = 0.0
    cent = jivf._kmeans(jnp.asarray(rows), 48, 2)[0]
    flat, _ = jivf._assign_spill(jnp.asarray(rows), cent, 3)
    probes, _ = jivf._probe_lists(jnp.asarray(rows), cent, 8)
    top = ivf._top_clusters(torch.from_numpy(rows),
                            torch.from_numpy(np.array(cent)), 8)
    np.testing.assert_array_equal(top[:, :3].reshape(-1).numpy(),
                                  np.asarray(flat))
    np.testing.assert_array_equal(top.numpy(), np.asarray(probes))
    np.testing.assert_array_equal(
        top.numpy(), ivf.top_clusters_plain(
            torch.from_numpy(rows), torch.from_numpy(np.array(cent)),
            8).numpy())


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """knn_ivf on CPU tensors calls top_clusters_plain, rescore_plain and
    merge_buffers_plain (each counted) and launches no kernel."""
    calls = {}
    for name in ("top_clusters_plain", "rescore_plain",
                 "merge_buffers_plain"):
        fn = getattr(ivf, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            assert all(a.device.type == "cpu" for a in args
                       if isinstance(a, torch.Tensor))
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ivf, name, counted)
    before = (ivf.rescore_clusters.kernel_launches,
              ivf.merge_probe_lists.kernel_launches)
    e = _blobs(6000, 32, 30, np.random.default_rng(4))
    idx, _ = ivf.knn_ivf(torch.from_numpy(e), 10, n_clusters=32)
    assert idx.shape == (6000, 10)
    assert calls["top_clusters_plain"] == 4  # three k-means passes + one
    assert calls["rescore_plain"] == 1 and calls["merge_buffers_plain"] == 1
    assert (ivf.rescore_clusters.kernel_launches,
            ivf.merge_probe_lists.kernel_launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """K6's and K7's wrappers take CUDA tensors only (the dispatch in
    _rescore and _merge_buffers sends CPU tensors to the plain
    versions)."""
    rows = _grid(np.random.default_rng(1), 600, 16)
    case = _ivf_case(rows, 8, 2, 1, 5)
    with pytest.raises(ValueError, match="CUDA"):
        _kernel(case, "bf16")
    with pytest.raises(ValueError, match="CUDA"):
        ivf.merge_probe_lists(torch.full((4, 2, 3), EMPTY_KEY), 3, 2)


def _bounds(counts):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                            .astype(np.int32))


def _rescore_units(counts_h, qcounts_h):
    """K6's work list as the host once made it, the reference
    bucket_units_plain is held to: (U, 4) int32 (cluster, first query
    slot, query slots, members) over the probed clusters, K6_ROWS slots a
    unit, the clusters with the most members first."""
    cl = np.flatnonzero(qcounts_h)
    cl = cl[np.argsort(-counts_h[cl], kind="stable")]
    per = -(-qcounts_h[cl] // ivf.K6_ROWS)
    c = np.repeat(cl, per)
    j0 = (np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)) \
        * ivf.K6_ROWS
    return np.stack([c, j0, np.minimum(ivf.K6_ROWS, qcounts_h[c] - j0),
                     counts_h[c]], axis=1).astype(np.int32)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("d", [3, 130, 500, 512])
def test_k6_rows_pad_to_a_16_byte_pitch(d, precision):
    """The rows rescore_clusters gives K6 (_tma_rows at the search's
    dtype): 16-byte aligned, at tma_width's pitch; past d zeros and before
    it the rows themselves. Where d * itemsize is a multiple of 16 no pad
    column is made: the rows are a copy in dtype, en_pad itself where it
    is that already; a misaligned base or strided rows are copied to
    aligned, contiguous ones."""
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    size = dtype.itemsize
    en = torch.from_numpy(_grid(np.random.default_rng(d), 37, d))
    pitch = tma_width(d, size)
    assert pitch * size % 16 == 0 and 0 <= pitch - d < 16 // size
    assert (pitch == d) == (d * size % 16 == 0)
    wide = torch.zeros((37, d + 4))
    wide[:, :d] = en
    for x in (en, en.to(dtype), wide[:, :d]):
        rows = _tma_rows(x, dtype)
        assert rows.dtype == dtype and rows.shape == (37, pitch)
        assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
        assert torch.equal(rows[:, :d], en.to(dtype))
        assert not bool(rows[:, d:].any())
        assert (rows.data_ptr() == x.data_ptr()) == (
            pitch == d and x.dtype == dtype and x.is_contiguous())
    flat = torch.zeros(37 * d + 1)
    flat[1:] = en.reshape(-1)
    off = flat[1:].view(37, d)
    rows = _tma_rows(off, dtype)
    assert rows.shape == (37, pitch) and rows.data_ptr() % 16 == 0
    assert torch.equal(rows[:, :d], en.to(dtype))


def test_rescore_units_cover_every_probed_slot():
    """K6's work list (bucket_units_plain, from the buckets' bounds):
    every probed cluster's query slots once, in units of at most K6_ROWS,
    each with its cluster's first member and its member count, the
    clusters with the longest member counts first, the empty ones
    included."""
    counts_h = np.array([5, 0, 300, 7, 0, 40])
    qcounts_h = np.array([129, 3, 0, 256, 0, 1])
    mb, qb = _bounds(counts_h), _bounds(qcounts_h)
    units = ivf.bucket_units_plain(mb, qb).numpy()
    assert units.dtype == np.int32 and units.shape[1] == 4
    cluster = np.searchsorted(qb.numpy(), units[:, 1], side="right") - 1
    slots = {(int(c), int(j - qb[c])) for c, (_, j0, q, _) in
             zip(cluster, units) for j in range(j0, j0 + q)}
    assert slots == {(c, j) for c in range(6) for j in range(qcounts_h[c])}
    assert (units[:, 2] <= ivf.K6_ROWS).all() and (units[:, 2] > 0).all()
    assert (units[:, 0] == mb.numpy()[cluster]).all()
    assert (units[:, 3] == counts_h[cluster]).all()
    length = [int(m).bit_length() for m in units[:, 3]]
    assert length == sorted(length, reverse=True)


def _rescore_plan_loop(counts_h, qcounts_h, qm, m_all):
    """_rescore_plan as a loop over the probed clusters, one at a time:
    the reference its vectorized form is held to."""
    groups = {}
    for c in np.flatnonzero(qcounts_h):
        key = (min(ivf._size_class(qcounts_h[c]), qm),
               min(ivf._size_class(counts_h[c]), m_all))
        groups.setdefault(key, []).append(int(c))
    return groups


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rescore_plan_is_the_loop(seed):
    """The vectorized _rescore_plan gives the loop's groups (keys, their
    order and each one's clusters) over counts with empty, unprobed and
    power-of-two clusters, caps below the largest class included; _add_plan
    the stats the search logs from them."""
    rng = np.random.default_rng(seed)
    c = int(rng.integers(50, 3000))
    counts_h = rng.integers(0, 2000, c)
    qcounts_h = rng.integers(0, 700, c)
    counts_h[rng.random(c) < 0.1] = 0
    qcounts_h[rng.random(c) < 0.1] = 0
    counts_h[:5] = [1, 128, 129, 256, 4096]
    qcounts_h[:5] = 1
    for qm, m_all in ((256, 512), (ivf._ceil128(qcounts_h.max()),
                                   ivf._ceil128(counts_h.max()))):
        want = _rescore_plan_loop(counts_h, qcounts_h, qm, m_all)
        got = ivf._rescore_plan(counts_h, qcounts_h, qm, m_all)
        assert got == want and list(got) == list(want)
    stats = {}  # the search's plan: tables as wide as the largest counts
    ivf._add_plan(stats, counts_h, qcounts_h)
    assert stats == {
        "pair_scores": sum(len(v) * q * m for (q, m), v in want.items()),
        "size_classes": len(want),
        "probed_clusters": int((qcounts_h > 0).sum()),
        "real_pair_scores": int((counts_h * qcounts_h).sum()),
        "max_members": int(counts_h.max())}


@pytest.mark.parametrize("sizes", [
    ([5, 0, 300, 7, 0, 40], [129, 3, 0, 256, 0, 1]),
    ([1, 128, 129, 256, 255, 2], [1, 128, 129, 1000, 0, 7]),
    ([0], [3])])
def test_plain_units_are_rescore_units_rows(sizes):
    """K6's work list from the buckets' bounds (bucket_units_plain, K11's
    reference) holds rescore_units' rows, each (cluster, first slot) at
    its buckets' offsets, as a set; its clusters by the bit length of
    their member count, longest first, then by id."""
    counts_h, qcounts_h = (np.array(x) for x in sizes)
    mb, qb = _bounds(counts_h), _bounds(qcounts_h)
    got = ivf.bucket_units_plain(mb, qb)
    assert got.dtype == torch.int32 and got.shape[1] == 4
    want = {(int(mb[c]), int(qb[c]) + j0, q, m)
            for c, j0, q, m in _rescore_units(counts_h, qcounts_h).tolist()}
    rows = [tuple(r) for r in got.tolist()]
    assert len(rows) == len(want) and set(rows) == want
    length = [int(m).bit_length() for *_, m in rows]
    assert length == sorted(length, reverse=True)
    firsts = [r[0] for r in rows]
    for b in set(length):  # within a length by cluster id (member offset)
        run = [f for f, lb in zip(firsts, length) if lb == b]
        assert run == sorted(run)


def _replay(case, stats=None):
    return ivf._k6_replay(case["en_pad"], case["n_real"], case["members"],
                          case["queries"], case["first"], case["nq"],
                          case["p"], case["kk_g"], stats)


@pytest.mark.parametrize("k", [1, 50, 64, 100])
def test_k6_replay_matches_plain_at_edge_cases(k):
    """K6's selection replayed (_k6_replay) bitwise rescore_plain at the
    edge cases (grid rows: ties to the lowest index; sentinel rows; k past
    a cluster's members; a cluster past the first selection's 256
    members), with the lists in shared memory (k <= 64) and not."""
    case = _edge_case(CPU, k)
    stats = {}
    assert torch.equal(_replay(case, stats), _plain(case))
    assert stats["merges"] > 0  # the 300-member cluster's last tile


@pytest.mark.parametrize("k", [1, 50, 64, 100])
def test_k6_replay_matches_plain_when_survivors_overflow(k):
    """_flood_case: every later tile's keys beat the thresholds, so rows
    overflow their survivor slots and the tile is offered again in
    rounds, merging between them: bitwise rescore_plain."""
    case = _flood_case(CPU, k)
    stats = {}
    assert torch.equal(_replay(case, stats), _plain(case))
    assert stats["rounds"] > 0 and stats["merges"] > 0


@pytest.mark.parametrize("spill", [1, 2])
def test_k6_replay_matches_plain_on_ivf_tables(spill):
    """knn_ivf's own tables on grid rows (C = 8: clusters of ~400-800
    members, past the first selection), k = 50: the replay bitwise
    rescore_plain, and the bisection within its 64 steps a row."""
    case = _ivf_case(_grid(np.random.default_rng(50 + spill), 3000, 32), 8,
                     2, spill, 50)
    assert int(case["counts_h"].max()) > ivf.K6_FIRST
    stats = {}
    assert torch.equal(_replay(case, stats), _plain(case))
    assert stats["steps"] <= 64 * case["nq"] * case["p"]


@pytest.mark.parametrize("spill", [1, 2])
def test_k6_replay_in_any_unit_order(spill):
    """K11 orders K6's units within a bit length of their member count by
    atomics; no unit writes another's lists, so the buffer does not depend
    on their order: the replay over the plain units reversed and shuffled
    bitwise rescore_plain."""
    case = _ivf_case(_grid(np.random.default_rng(60 + spill), 3000, 32), 8,
                     3, spill, 30)
    want = _plain(case)
    q = case["queries"]
    for order in (torch.arange(q.units.shape[0] - 1, -1, -1),
                  torch.randperm(q.units.shape[0],
                                 generator=torch.Generator().manual_seed(7))):
        case["queries"] = q._replace(units=q.units[order])
        assert torch.equal(_replay(case), want)


def test_kth_key_replay_on_ties():
    """The bisection (csrc/ivf_rescore.cu kth_key) on keys whose scores
    tie in runs: for every need a key t with exactly need keys at or above
    it, at most the need-th largest, in at most 64 steps (32 on the high
    words, 32 on the low words)."""
    rng = np.random.default_rng(12)
    scores = torch.from_numpy((rng.integers(-3, 4, 200) / 8).astype(
        np.float32))
    keys = _order_keys(scores, torch.from_numpy(rng.permutation(200)))
    keys = torch.cat([keys, torch.full((56,), EMPTY_KEY)]).numpy()
    want = np.sort(keys[keys != EMPTY_KEY])[::-1]
    for need in range(1, 201):
        t, steps = ivf._kth_key_replay(keys, need)
        assert (want >= t).sum() == need and t <= want[need - 1]
        assert steps <= 64


def test_merge_top_replay_is_the_top_of_both_runs():
    """The merge network's step (keys_sm90.cuh merge_top): the top T of
    two descending runs, sorted descending, EMPTY_KEY padding included."""
    rng = np.random.default_rng(13)
    for t in (64, 128, 512):
        a, b = (torch.sort(_order_keys(torch.from_numpy(
            rng.standard_normal((20, t)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 4 * t, (20, t)))), dim=1,
            descending=True).values for _ in range(2))
        b[:, t // 3 :] = EMPTY_KEY
        want = torch.topk(torch.cat([a, b], 1), t, dim=1).values
        assert torch.equal(ivf._merge_top_replay(a, b), want)


@pytest.mark.parametrize("shape", [(300, 8, 50, 50), (50, 3, 7, 10),
                                   (20, 40, 20, 300), (16, 1, 64, 64),
                                   (12, 40, 20, 600)])
@pytest.mark.parametrize("spill", [1, 2, 3])
def test_k7_replay_matches_plain_on_sorted_lists(shape, spill):
    """K7's merge network, dedup and exact finish replayed (_k7_replay)
    bitwise merge_buffers_plain on sorted lists whose indices recur at
    other scores; with dedup such rows finish exactly, as every row does
    past the network's 512 keys."""
    rows, p, w, k = shape
    buf = _sorted_lists(np.random.default_rng(rows + spill), rows, p, w,
                        CPU)
    got, exact_rows = ivf._k7_replay(buf, k, spill)
    assert torch.equal(got, ivf.merge_buffers_plain(buf, k, spill))
    assert (exact_rows > 0) == (spill > 1 or k > ivf.K7_RUN_MAX)


@pytest.mark.parametrize("spill", [2, 3])
def test_k7_replay_on_rescore_buffers_needs_no_exact_finish(spill):
    """On a rescore's buffer an index recurs only as exact copies (a row
    scored in two probed clusters), so no row of the network needs the
    exact finish: bitwise merge_buffers_plain, no row finished exactly."""
    rows = _blobs(4000, 32, 30, np.random.default_rng(spill))
    case = _ivf_case(rows, 16, 6, spill, 20)
    buf = _plain(case)
    got, exact_rows = ivf._k7_replay(buf, 20, spill)
    assert torch.equal(got, ivf.merge_buffers_plain(buf, 20, spill))
    assert exact_rows == 0


def test_k7_run_covers_k_times_the_copies():
    """K7's run T: 64 at least, k times min(spill, p) with dedup, at most
    512 (past that every row finishes exactly)."""
    assert ivf._k7_run(50, 8, 1) == 64
    assert ivf._k7_run(50, 8, 2) == 128
    assert ivf._k7_run(50, 8, 3) == 256
    assert ivf._k7_run(50, 1, 3) == 64
    assert ivf._k7_run(300, 40, 2) == 512


# --------------------------------------------------------------- cuda


def _edge_case(device, k=50):
    """C = 8 clusters on grid rows of d = 512: 1, 300 (past a tile and the
    first selection's 256), 20 (k = 50 past its members), 60 (ten
    sentinel rows >= n_real, which would score best), 100 (never probed),
    0 (probed), 129 and 200 members, clusters sharing rows; 300 query
    rows from row 100, 3 probes each; k neighbors."""
    rng = np.random.default_rng(16)
    n_real, d = 900, 512
    rows = _grid(rng, n_real + 40, d)
    rows[n_real:] = 8 / 64
    en_pad = torch.cat([torch.from_numpy(rows), torch.zeros((1, d))])
    sizes = [1, 300, 20, 60, 100, 0, 129, 200]
    member = np.full((8, ivf._ceil128(max(sizes))), n_real, np.int32)
    for c, m in enumerate(sizes):
        member[c, :m] = rng.choice(n_real, m, replace=False)
    member[3, ::6][:10] = n_real + np.arange(10)
    probes = np.stack([rng.choice([0, 1, 2, 3, 5, 6, 7], 3, replace=False)
                       for _ in range(300)]).astype(np.int32)
    return _case(en_pad.to(device), n_real,
                 torch.from_numpy(member).to(device), sizes,
                 torch.from_numpy(probes).to(device), k, first=100)


def _flood_case(device, k=50):
    """A cluster whose members score higher tile by tile, for every query
    (K6's survivors overflow): 700 members, member i's first level(i) of
    64 values 8 / 64 and the rest -8 / 64, 130 queries of all 1 / 64
    (score (2 level - 64) / 512). Levels: i // 8 over the first 256
    members, then 40 members at 32 and 88 at 0 (40 survivors, fewer than
    a merge asks for at the larger slots), then 128 at 33 (every key of
    the tile beats every earlier one), then the rest at 34 + (i - 512) //
    40; ties to the lowest index. A second cluster of 90 members with 10
    rows >= n_real; queries probe both (2 probes)."""
    n_real, d = 1000, 64
    level = np.concatenate([np.arange(256) // 8, np.full(40, 32),
                            np.zeros(88, np.int64), np.full(128, 33),
                            34 + np.arange(188) // 40])
    rows = np.full((n_real + 20, d), -8 / 64, np.float32)
    for i, lv in enumerate(level):
        rows[i, :lv] = 8 / 64
    rows[700:830] = 1 / 64
    rows[830:n_real] = _grid(np.random.default_rng(41), n_real - 830, d)
    rows[n_real:] = 8 / 64
    en_pad = torch.cat([torch.from_numpy(rows), torch.zeros((1, d))])
    member = np.full((2, 768), n_real, np.int32)
    member[0, :700] = np.arange(700)
    member[1, :90] = 830 + np.arange(90)
    member[1, ::9][:10] = n_real + np.arange(10)
    probes = np.tile(np.array([[0, 1]], np.int32), (130, 1))
    return _case(en_pad.to(device), n_real,
                 torch.from_numpy(member).to(device), [700, 90],
                 torch.from_numpy(probes).to(device), k, first=700)


def _sorted_lists(rng, rows, p, w, device):
    """(rows, p, w) keys, each list sorted descending, indices drawn from
    3 w values (recurring across a row's lists at other scores), EMPTY_KEY
    tails of random length, the first rows empty."""
    s = torch.from_numpy(rng.standard_normal((rows, p, w)).astype(
        np.float32))
    keys = _order_keys(s, torch.from_numpy(rng.integers(0, 3 * w,
                                                        (rows, p, w))))
    keys.masked_fill_(torch.from_numpy(
        np.arange(w)[None, None, :] >= rng.integers(0, w + 1,
                                                    (rows, p, 1))),
        EMPTY_KEY)
    keys[: max(1, rows // 50)] = EMPTY_KEY
    return torch.sort(keys, dim=2, descending=True).values.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("spill", [1, 2])
@pytest.mark.parametrize("k", [50, 64, 100])
@pytest.mark.parametrize("d", [512, 500, 130])
def test_ivf_rescore_bitwise_on_grid_rows(cuda, precision, spill, k, d):
    """K6 against rescore_plain on grid rows (every score exact) through
    knn_ivf's own tables: bitwise, ties to the lowest index included; C =
    16 makes clusters of ~300-700 members (past the first selection's
    256); W = 64 the largest with the lists in shared memory, W = 100 the
    form with lists in the buffer. d = 500 (the CLI's default width: 1,000
    bytes a bf16 row) and 130 (no multiple of 4) go in as a padded copy
    where d * itemsize is no multiple of 16, counted in .padded_launches."""
    rows = _grid(np.random.default_rng(30 + spill), 5000, d)
    case = _ivf_case(rows, 16, 4, spill, k, cuda)
    assert int(case["counts_h"].max()) > ivf.K6_FIRST
    before = ivf.rescore_clusters.padded_launches
    assert torch.equal(_kernel(case, precision), _plain(case))
    assert ivf.rescore_clusters.padded_launches - before == int(
        tma_width(d, 2 if precision == "bf16" else 4) != d)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("k", [1, 50, 64, 100])
def test_ivf_rescore_edge_cases(cuda, precision, k):
    """_edge_case bitwise, and no sentinel row in any list."""
    case = _edge_case(cuda, k)
    got = _kernel(case, precision)
    assert torch.equal(got, _plain(case))
    _, idx = _decode_keys(got[got != EMPTY_KEY])
    assert bool((idx < case["n_real"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("k", [1, 50, 64, 100])
def test_ivf_rescore_when_survivors_overflow(cuda, precision, k):
    """_flood_case (rows overflow their survivor slots, tiles offered
    again in rounds): bitwise rescore_plain and K6's replay."""
    case = _flood_case(cuda, k)
    got = _kernel(case, precision)
    assert torch.equal(got, _plain(case))
    assert torch.equal(got.cpu(), _replay(case))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("which", ["edge", "flood", "ivf"])
def test_ivf_rescore_device_units_match_host_units(cuda, precision, which):
    """K6 fed K11's work list (made on the card, a grid of k6_grid blocks
    of which those past its device count return at once) writes the
    buffer K6 fed the host's list (ivf.host_units: bucket_units_plain,
    held to rescore_units' rows on the CPU) writes, bitwise, and
    both are rescore_plain's: the edge and overflow cases, and knn_ivf's
    own members and probes on blobs (C = 64, p = 8, spill 2)."""
    case = (_edge_case(cuda) if which == "edge" else _flood_case(cuda)
            if which == "flood" else _ivf_case(_grid(
                np.random.default_rng(70), 8000, 128), 64, 8, 2, 50, cuda))
    q = case["queries"]
    assert q.units.shape[0] == ivf.k6_grid(case["nq"] * case["p"],
                                           case["member"].shape[0])
    assert int(q.n_units[0]) == len(_rescore_units(case["counts_h"],
                                                   case["qcounts_h"]))
    got = _kernel(case, precision)
    assert torch.equal(got, _kernel(case, precision,
                                       ivf.host_units(case["members"], q)))
    assert torch.equal(got, _plain(case))


@pytest.mark.cuda
def test_knn_ivf_reads_nothing_back_before_k6(cuda, monkeypatch):
    """knn_ivf on the card makes no synchronizing call from _tables'
    return until K6 is enqueued (torch.cuda.set_sync_debug_mode("error")
    over that span: the member side, the probe side and K6's launch), and
    gives the result it gives without the check."""
    from fedrann_tpu_torch import _build

    tables, launch = ivf._tables, _build.launch
    spans = []

    def after_tables(*args, **kwargs):
        out = tables(*args, **kwargs)
        torch.cuda.set_sync_debug_mode("error")
        spans.append("open")
        return out

    def then_k6(name, *args, **kwargs):
        try:
            return launch(name, *args, **kwargs)
        finally:
            if name == "fk_ivf_rescore":
                torch.cuda.set_sync_debug_mode("default")
                spans.append("closed")

    e = torch.from_numpy(_blobs(8000, 128, 40,
                                np.random.default_rng(3))).to(cuda)
    want = ivf.knn_ivf(e, 20, n_clusters=64)
    monkeypatch.setattr(ivf, "_tables", after_tables)
    monkeypatch.setattr(_build, "launch", then_k6)
    try:
        got = ivf.knn_ivf(e, 20, n_clusters=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert spans == ["open", "closed"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("d", [512, 500])
def test_ivf_rescore_real_rows(cuda, precision, d):
    """Unit blobs (bf16-rounded at bf16), d = 512 and 500: the same unset
    slots, strictly descending lists, index-set agreement >= 0.999 and
    shared pairs' scores within 2e-6; two launches byte-identical; at d =
    500 bitwise K6 on the same rows with zero columns to 512 (no padded
    copy): the pad changes no score's bits."""
    rows = _blobs(20000, d, 60, np.random.default_rng(9))
    if precision == "bf16":
        rows = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    case = _ivf_case(rows, 128, 8, 2, 50, cuda)
    got = _kernel(case, precision)
    assert torch.equal(got, _kernel(case, precision))
    if d != 512:
        wide = dict(case, en_pad=torch.nn.functional.pad(case["en_pad"],
                                                         (0, 512 - d)))
        assert torch.equal(got, _kernel(wide, precision))
    want = _plain(case)
    w = got.shape[-1]
    g, wt = got.reshape(-1, w), want.reshape(-1, w)
    assert torch.equal(g == EMPTY_KEY, wt == EMPTY_KEY)
    assert bool(((g[:, 1:] < g[:, :-1]) | (g[:, 1:] == EMPTY_KEY)).all())
    agree, err = _set_agreement(g.cpu(), wt.cpu())
    assert agree >= 0.999 and err <= 2e-6, (agree, err)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", [1, 2, 3])
def test_ivf_merge_bitwise_on_rescore_buffers(cuda, spill):
    """K7 against merge_buffers_plain on K6's own buffers (tables of
    spill 1, 2 and 3, merged at that spill): bitwise."""
    rows = _blobs(8000, 128, 40, np.random.default_rng(spill))
    case = _ivf_case(rows, 64, 8, spill, 50, cuda)
    buf = _kernel(case, "bf16")
    assert torch.equal(ivf.merge_probe_lists(buf, 50, spill),
                       ivf.merge_buffers_plain(buf, 50, spill))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 8, 50, 50), (500, 3, 7, 10),
                                   (200, 40, 20, 300), (64, 1, 64, 64),
                                   (50, 40, 20, 600)])
@pytest.mark.parametrize("spill", [1, 2, 3])
def test_ivf_merge_bitwise_on_sorted_lists(cuda, shape, spill):
    """K7 on sorted lists whose indices recur at other scores (the
    highest copy kept; with dedup such rows take the exact finish), rows
    with fewer distinct indices than k (EMPTY_KEY tails), empty rows, k
    past the network's 512: bitwise merge_buffers_plain and _k7_replay."""
    rows, p, w, k = shape
    buf = _sorted_lists(np.random.default_rng(rows + spill), rows, p, w,
                        cuda)
    got = ivf.merge_probe_lists(buf, k, spill)
    assert torch.equal(got, ivf.merge_buffers_plain(buf, k, spill))
    want, exact_rows = ivf._k7_replay(buf.cpu(), k, spill)
    assert torch.equal(got.cpu(), want)
    # the exact finish ran
    assert (exact_rows > 0) == (spill > 1 or k > ivf.K7_RUN_MAX)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
def test_top_clusters_through_k4(cuda, bf16):
    """_top_clusters on the card (K4) against top_clusters_plain:
    agreement >= 0.999 at t = 1 and t = 8 over 64 and 8 centroids (C < a
    tile of 128), and of two equal centroids the lower id always first."""
    from fedrann_tpu_torch.knn.topk import merge_block

    rows = torch.from_numpy(_blobs(20000, 256, 50,
                                   np.random.default_rng(5))).to(cuda)
    for c in (64, 8):
        cent = ivf._kmeans(rows, c, 2, bf16=bf16)
        cent[c - 1] = cent[2]
        for t in (1, min(8, c)):
            before = merge_block.kernel_launches
            got = ivf._top_clusters(rows, cent, t, bf16).cpu().numpy()
            assert merge_block.kernel_launches == before + 1
            want = ivf.top_clusters_plain(rows, cent, t, bf16).cpu().numpy()
            both = np.sort(np.concatenate([got, want], axis=1), axis=1)
            agree = (both[:, 1:] == both[:, :-1]).sum() / want.size
            assert agree >= 0.999, (c, t, agree)
            has_hi, has_lo = (got == c - 1).any(1), (got == 2).any(1)
            assert not (has_hi & ~has_lo).any()
            assert (np.argmax(got == 2, 1) < np.argmax(got == c - 1, 1))[
                has_hi].all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("d", [128, 500, 130])
def test_knn_ivf_runs_k4_k6_k7_and_no_plain_version(cuda, monkeypatch,
                                                     precision, d):
    """knn_ivf on CUDA tensors: K4 (four cluster rankings), K6 and K7 one
    launch each, no plain version called; K6 on a padded copy where d *
    itemsize is no multiple of 16, the pitch it launched at (504 at the
    CLI's d = 500 in bf16) in `.last`."""
    from fedrann_tpu_torch.knn.topk import merge_block

    for name in ("top_clusters_plain", "rescore_plain",
                 "merge_buffers_plain"):
        monkeypatch.setattr(ivf, name, lambda *a, _n=name, **k: pytest.fail(
            f"{_n} called on the card"))
    counts = lambda: (merge_block.kernel_launches,  # noqa: E731
                      ivf.rescore_clusters.kernel_launches,
                      ivf.rescore_clusters.fp32_launches,
                      ivf.rescore_clusters.padded_launches,
                      ivf.merge_probe_lists.kernel_launches)
    before = counts()
    e = torch.from_numpy(_blobs(8000, d, 40,
                                np.random.default_rng(2))).to(cuda)
    idx, dist = ivf.knn_ivf(e, 20, n_clusters=64, precision=precision)
    after = counts()
    pitch = {(128, "bf16"): 128, (128, "fp32"): 128, (500, "bf16"): 504,
             (500, "fp32"): 500, (130, "bf16"): 136,
             (130, "fp32"): 132}[d, precision]
    assert tuple(a - b for a, b in zip(after, before)) == (
        4, 1, int(precision == "fp32"), int(pitch != d), 1)
    assert ivf.knn_ivf.last["k6_row_pitch"] == pitch
    assert (idx[:, 0] == np.arange(8000)).mean() > 0.99
    assert (np.diff(dist, axis=1) >= 0).all()


@pytest.mark.cuda
def test_ivf_kernels_launch_on_their_tensors_card(last_card):
    """With cuda:0 current, K6 and K7 on the last card's tensors launch
    there and match their plain versions."""
    case = _edge_case(last_card)
    got = _kernel(case, "bf16")
    merged = ivf.merge_probe_lists(got, 50, 2)
    torch.cuda.synchronize(last_card)
    assert torch.cuda.current_device() == 0
    assert got.device == last_card and merged.device == last_card
    want = _plain(case)
    assert torch.equal(got, want)
    assert torch.equal(merged, ivf.merge_buffers_plain(want, 50, 2))


@pytest.mark.cuda
def test_knn_ivf_sharded_over_every_card_is_knn_ivf(last_card):
    """knn_ivf_sharded over a mesh of every card (the member buckets
    replicated, each card's probe side, K6 and K7 enqueued before any
    entry waits) gives knn_ivf's result on one card bitwise, at a cluster
    count the cards divide and blocks of unequal rows; K11 launches once
    for the member side and once a card for the probe sides."""
    from fedrann_tpu_torch.parallel.mesh import make_mesh

    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    c = -(-64 // len(cards)) * len(cards)
    e = torch.from_numpy(_blobs(20_001, 128, 60, np.random.default_rng(4)))
    want = ivf.knn_ivf(e.to(cards[0]), 20, n_clusters=c)
    before = (ivf.bucket_clusters.kernel_launches,
              ivf.bucket_clusters.probe_launches)
    got = ivf.knn_ivf_sharded(e, 20, mesh=make_mesh(devices=cards),
                              n_clusters=c)
    assert (ivf.bucket_clusters.kernel_launches - before[0],
            ivf.bucket_clusters.probe_launches - before[1]) == (
        1 + len(cards), len(cards))
    assert ivf.knn_ivf_sharded.last["entries"] == len(cards)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
