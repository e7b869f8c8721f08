"""fedrann_tpu_torch projection and membership+embed (the plain versions of
kernel C's sign and dense forms) against the JAX functions and the Pallas
`merge_embed` kernel in interpret mode.

SRP signs and magnitudes are bitwise. Hit rows are bitwise; embedding rows
agree to rtol 1e-5 with atol 1e-6 * max|P| * hits, because the f32 sums
run in another order (the JAX path sums in a sum/difference basis, the
Pallas kernel row by row). A bfloat16 table with no sign structure allows
2^-8 * max|P| * hits: the JAX form rounds gl + gr and gl - gr to bfloat16
where XLA does not keep them in float32."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench"))

from fedrann_tpu import oracle  # noqa: E402
from fedrann_tpu.kmers import membership as jmem  # noqa: E402
from fedrann_tpu.project import embed as jembed  # noqa: E402
from fedrann_tpu.project import srp as jsrp  # noqa: E402
from fedrann_tpu_torch.convert import (  # noqa: E402
    paired_table_to_port,
    signs_to_port,
    staged_planes_to_slots,
)
from fedrann_tpu_torch.io.fastx import FastxRecord  # noqa: E402
from fedrann_tpu_torch.io.packing import pack_reads  # noqa: E402
from fedrann_tpu_torch.kmers.codec import sample_threshold  # noqa: E402
from fedrann_tpu_torch.kmers.membership import (  # noqa: E402
    _pow2,
    read_hits_staged,
)
from fedrann_tpu_torch.project import srp  # noqa: E402
from fedrann_tpu_torch.project.embed import (  # noqa: E402
    DENSE_BLOCK_WARPS,
    DENSE_COLS,
    DENSE_LAG,
    DENSE_PARTS_MAX,
    DENSE_WARPS_PER_SM,
    DENSE_WINDOW_BYTES,
    dense_plan,
    embed_hits_paired,
    membership_embed,
    membership_embed_dense,
)
from fedrann_tpu_torch.sim import simulate_reads  # noqa: E402
from pallas_embed import build_q_cat, merge_embed, prepare_library  # noqa: E402

SEED, FRACTION = 21, 0.3


@pytest.mark.parametrize("chunk", [1 << 16, 700])
def test_srp_signs_and_mags_bitwise(chunk):
    rng = np.random.default_rng(0)
    lib, d = 3000, 96
    counts = rng.integers(2, 50, lib).astype(np.int32)
    signs_j, mags_j = jsrp.build_precompute_signs(jnp.asarray(counts), d,
                                                  2094, None, chunk=chunk)
    signs_j, mags_j = signs_to_port(signs_j, mags_j)
    signs, mags = srp.build_precompute_signs(
        torch.from_numpy(counts.astype(np.int64)), d, 2094, None, chunk=chunk)
    np.testing.assert_array_equal(signs.numpy(), signs_j)
    np.testing.assert_array_equal(mags.numpy(), mags_j)
    icf_j = np.asarray(jsrp.icf_weights_device(jnp.asarray(counts)))
    np.testing.assert_array_equal(
        srp.icf_weights(torch.from_numpy(counts)).numpy(), icf_j)


def _setup(k, d, genome=6000, frac=FRACTION):
    """JAX-staged candidates (as numpy planes), the oracle library, and its
    sign-packed projection."""
    sim = simulate_reads(genome_length=genome, coverage=5,
                         mean_read_length=700, seed=SEED)
    lib = oracle.build_library(sim.sequences, k, 2, frac, SEED)
    bases = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(1024,)).buckets[0].bases
    planes, _ = jmem.stage_candidates(
        jnp.asarray(bases), k, 512, False, jnp.uint32(SEED),
        jnp.uint32(sample_threshold(frac)))
    planes = tuple(np.asarray(p) for p in planes)
    signs, mags = jsrp.build_precompute_signs(
        jnp.asarray(lib.counts.astype(np.int32)), d, 2094, None)
    return lib, planes, signs, mags


def _port_embed(lib, planes, k, signs, mags, d):
    slots = torch.from_numpy(staged_planes_to_slots(planes, k))
    r = slots.shape[0]
    signs_p, mags_p = signs_to_port(signs, mags)
    targets = torch.stack([2 * torch.arange(r), 2 * torch.arange(r) + 1],
                          dim=1)
    out = torch.zeros((2 * r, d))
    n_hits = membership_embed(
        slots, torch.from_numpy(lib.codes.astype(np.int64)),
        torch.from_numpy(signs_p), torch.from_numpy(mags_p), targets, out)
    return slots, out.numpy(), n_hits.numpy()


def _atol(mags, n_hits):
    return 1e-6 * float(np.abs(np.asarray(mags)).max()) * max(
        int(np.max(n_hits)), 1)


@pytest.mark.parametrize("k", [13, 16, 21])
def test_membership_embed_matches_jax(k):
    d = 64
    lib, planes, signs, mags = _setup(k, d)
    index = jmem.build_library_index(lib.codes, k)
    hits_j, n_hits_j = jmem._read_hits_staged(
        tuple(jnp.asarray(p) for p in planes), index.words, index.table, k,
        index.bits, index.steps, index.packed)
    e_fwd, e_rev = jembed.embed_hits_paired_signs(hits_j, signs, mags,
                                                  lib.size, d)
    slots, out, n_hits = _port_embed(lib, planes, k, signs, mags, d)

    hits, n_hits_plain = read_hits_staged(
        slots, torch.from_numpy(lib.codes.astype(np.int64)))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_j))
    np.testing.assert_array_equal(n_hits, np.asarray(n_hits_j))
    np.testing.assert_array_equal(n_hits_plain.numpy(), n_hits)
    assert n_hits.sum() > 0
    atol = _atol(mags, n_hits)
    np.testing.assert_allclose(out[0::2], np.asarray(e_fwd), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(out[1::2], np.asarray(e_rev), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize("k", [13, 15, 16])
def test_membership_embed_matches_pallas_merge_embed(k):
    """merge_embed streams a dense f32 table; build it from the same sign
    table so both sides project with identical entries."""
    d = 64
    lib, planes, signs, mags = _setup(k, d)
    s = np.asarray(signs)
    fields = (s[..., None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    vals = ((fields == 1).astype(np.float32)
            - (fields == 2).astype(np.float32))
    paired = vals.reshape(lib.size + 1, -1)[:, : 2 * d] \
        * np.asarray(mags)[:, None]
    p_ext = np.concatenate([paired[: lib.size, :d], paired[: lib.size, d:],
                            np.zeros((1, d), np.float32)])
    e_f, e_r, nh = merge_embed(
        tuple(jnp.asarray(p) for p in planes),
        prepare_library(lib.codes, k),
        build_q_cat(jnp.asarray(p_ext), lib.size, tile=128),
        k=k, lib_size=lib.size, tile=128, block_rows=8, interpret=True)
    _, out, n_hits = _port_embed(lib, planes, k, signs, mags, d)
    np.testing.assert_array_equal(n_hits, np.asarray(nh))
    atol = _atol(mags, n_hits)
    np.testing.assert_allclose(out[0::2], np.asarray(e_f)[:, :d], rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(out[1::2], np.asarray(e_r)[:, :d], rtol=1e-5,
                               atol=atol)
    zero = n_hits == 0
    assert np.all(out[0::2][zero] == 0) and np.all(out[1::2][zero] == 0)


# ---- kernel C's schedule (csrc/membership_embed.cu), emulated in numpy ----

C_THREADS, C_TILE = 256, 1024


def _prefix_table(lib: np.ndarray):
    """Kernel C's prefix table of a non-empty library, filled as its
    pre-pass fills it (entry i writes the buckets after its left
    neighbour's, up to its own): (start, shift, n_buckets)."""
    size = len(lib)
    n_buckets = _pow2(size)
    t = n_buckets.bit_length() - 1
    shift = max(0, int(lib[-1]).bit_length() - t)
    hi = np.concatenate([lib >> shift, [n_buckets]])
    lo = np.concatenate([[-1], lib >> shift])
    start = np.repeat(np.arange(size + 1), hi - lo)
    assert len(start) == n_buckets + 1
    return start, shift, n_buckets


def _kernel_c_positions(lib: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Kernel C's lookup of each code (>= 0): its bucket's library range
    [start[p], start[p + 1]) from the prefix table, then the lower bound
    inside it. A code past the last bucket, or an empty library, gives 0
    (never a hit: the hit test compares the code)."""
    if not len(lib):
        return np.zeros(len(codes), dtype=np.int64)
    start, shift, n_buckets = _prefix_table(lib)
    p = codes >> shift
    inside = p < n_buckets
    at = np.where(inside, start[np.minimum(p, n_buckets - 1)], 0)
    end = np.where(inside, start[np.minimum(p, n_buckets - 1) + 1], 0)
    return np.array([a + np.searchsorted(lib[a:e], c)
                     for a, e, c in zip(at, end, codes)], dtype=np.int64)


@pytest.mark.parametrize("size", [1, 1000, 300_000])
def test_kernel_c_prefix_table_matches_searchsorted(size):
    """The pre-pass's fill rule gives start[p] = searchsorted(lib, p <<
    shift) for every bucket; the shift spreads the codes over the table."""
    rng = np.random.default_rng(size)
    lib = np.unique(rng.integers(0, 1 << 40, size + size // 10))[:size]
    start, shift, n_buckets = _prefix_table(lib.astype(np.int64))
    want = np.searchsorted(lib, np.arange(n_buckets + 1, dtype=np.int64)
                           << shift)
    np.testing.assert_array_equal(start, want)
    # the largest code's bucket is in the table's upper half (or no shift)
    assert lib[-1] >> shift < n_buckets
    assert shift == 0 or lib[-1] >> shift >= n_buckets // 2


@pytest.mark.parametrize("size", [0, 1, 2047, 2049, 300_000])
def test_kernel_c_lookup_matches_searchsorted(size):
    """Where a code is in the library, kernel C's prefix-table lookup finds
    the position torch.searchsorted gives; where it is not, it reports no
    hit: codes below, above, between and equal to library codes, with the
    empty and one-code libraries."""
    rng = np.random.default_rng(size)
    lib = np.unique(rng.integers(0, 1 << 40, size + size // 10))[:size]
    lib = lib.astype(np.int64)
    codes = np.concatenate([
        lib[rng.integers(0, max(size, 1), 500)] if size else [],
        rng.integers(0, 1 << 40, 500), [0, 1, (1 << 40) + 5, 1 << 61]]
    ).astype(np.int64)
    pos = _kernel_c_positions(lib, codes)
    want = torch.searchsorted(torch.from_numpy(lib),
                              torch.from_numpy(codes)).numpy()
    found = (want < size) & (lib[np.minimum(want, max(size - 1, 0))]
                             == codes) if size else np.zeros(len(codes), bool)
    got_found = (pos < size) & (lib[np.minimum(pos, max(size - 1, 0))]
                                == codes) if size else np.zeros(len(codes),
                                                                bool)
    np.testing.assert_array_equal(got_found, found)
    np.testing.assert_array_equal(pos[found], want[found])
    if size:
        assert found.sum() >= 500


def _group_fields(words: np.ndarray, d: int) -> tuple:
    """Kernel C's `group_words` for every column group of one sign row:
    (left, right) (d,) int codes, left = fields c (P[j]), right = fields
    d + c (P[j+L]), read as 32-bit words (the right ones funnel-shifted
    when d is not a multiple of 16) with fields of columns >= d cleared."""
    w = words.astype(np.uint32).astype(np.uint64)
    n_words = len(w)
    g = np.arange(-(-d // 16))
    c = 16 * g
    keep = np.where(d - c >= 16, 0xFFFFFFFF,
                    (1 << (2 * np.minimum(d - c, 15))) - 1).astype(np.uint64)
    left = w[g] & keep
    a, sh = (d + c) >> 4, (2 * ((d + c) & 15)).astype(np.uint64)
    nxt = np.where(a + 1 < n_words, w[np.minimum(a + 1, n_words - 1)], 0)
    right = ((w[a] >> sh) | np.where(sh > 0, nxt << (32 - sh), 0)) \
        & 0xFFFFFFFF & keep
    shifts = 2 * np.arange(16, dtype=np.uint64)
    fields = [((x[:, None] >> shifts) & 3).reshape(-1)[:d].astype(np.int64)
              for x in (left, right)]
    return fields[0], fields[1]


def _emulate_kernel_c(staged, lib, signs, mags, d):
    """Kernel C's sums in its order: per row and column chunk of up to
    C_THREADS groups, each tile's hits (slot order) dealt to parts
    e % parts; each part adds +-mags[j] of the nonzero fields of its hits
    in order (float32); a column is the sum of its parts in part order.
    Returns (fwd, rev) float32 and n_hits."""
    r, h = staged.shape
    size = len(lib)
    n_groups = -(-d // 16)
    fwd = np.zeros((r, d), np.float32)
    rev = np.zeros((r, d), np.float32)
    n_hits = np.zeros(r, np.int32)
    for i in range(r):
        row = staged[i]
        prev = np.concatenate([[PAD], row[:-1]])
        codes = row >> 1
        pos = _kernel_c_positions(lib, codes)
        hit = (row != PAD) & (row != prev) & (pos < size)
        hit &= lib[np.minimum(pos, max(size - 1, 0))] == codes if size \
            else False
        n_hits[i] = hit.sum()
        for g0 in range(0, n_groups, C_THREADS):
            groups = min(n_groups - g0, C_THREADS)
            parts = C_THREADS // groups
            cols = slice(16 * g0, min(d, 16 * (g0 + groups)))
            sums = np.zeros((parts, 2, cols.stop - cols.start), np.float32)
            for t0 in range(0, h, C_TILE):
                tile = np.nonzero(hit[t0 : t0 + C_TILE])[0] + t0
                for e, slot in enumerate(tile):
                    j, swap = pos[slot], (row[slot] & 1) == 0
                    left, right = _group_fields(signs[j], d)
                    m = mags[j]
                    vals = [np.where(f == 1, m, np.where(f == 2, -m, 0))
                            .astype(np.float32)[cols] for f in (left, right)]
                    if swap:
                        vals.reverse()
                    sums[e % parts, 0] += vals[0]
                    sums[e % parts, 1] += vals[1]
            for q in range(parts):
                fwd[i, cols] += sums[q, 0]
                rev[i, cols] += sums[q, 1]
    return fwd, rev, n_hits


PAD = np.iinfo(np.int64).max


@pytest.mark.parametrize("d,density,rows", [
    (40, None, 6),     # d % 16 = 8: right words funnel-shifted
    (100, None, 6),
    (512, 0.3, 4),     # a dense table: many nonzero fields per word
    (1500, None, 3),   # 94 groups, 2 parts
    (4100, 0.05, 2),   # past 256 groups: two column chunks
])
def test_kernel_c_schedule_matches_plain(d, density, rows):
    """Kernel C's schedule reproduces the plain version: hit counts
    bitwise, sums to the tolerance of float32 sums taken in another order,
    with repeated slots, rows longer than one tile and a padding row."""
    rng = np.random.default_rng(d)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 2400, rows)
    bases = torch.from_numpy(np.stack([genome[s : s + 2400] for s in starts]))
    from fedrann_tpu_torch.kmers.codec import canonical_sample
    from fedrann_tpu_torch.kmers.library import build_library
    from fedrann_tpu_torch.kmers.membership import select_candidates
    slots = canonical_sample(bases, 13, 9, sample_threshold(0.5), False)
    staged, _ = select_candidates(slots, 1100, False, None)
    staged[0, 10:40] = staged[0, 10]   # a run of one repeated slot
    staged[-1] = PAD                   # a row of padding only
    library = build_library([staged], 2, 0.5, 9)
    signs, mags = srp.build_precompute_signs(library.counts, d, 2094, density)
    targets = torch.stack([2 * torch.arange(rows), 2 * torch.arange(rows) + 1],
                          dim=1)
    out = torch.zeros((2 * rows, d))
    n_hits = membership_embed(staged, library.codes, signs, mags, targets, out)
    fwd, rev, n_emul = _emulate_kernel_c(
        staged.numpy(), library.codes.numpy(), signs.numpy(), mags.numpy(), d)
    np.testing.assert_array_equal(n_emul, n_hits.numpy())
    assert n_hits[:-1].min() > 0 and n_hits[-1] == 0
    atol = _atol(mags.numpy(), n_hits.numpy())
    np.testing.assert_allclose(fwd, out[0::2].numpy(), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(rev, out[1::2].numpy(), rtol=1e-5, atol=atol)


# ---- kernel C's dense form: plain version against JAX and merge_embed ----


def _dense_table(lib_size, d, kind, seed=0):
    """A (L+1, 2d) paired table: "f32"/"bf16" from build_precompute_paired
    (every nonzero of a row one magnitude), "normal" float32 or
    "normal_bf16" entries with no sign structure; row L zero."""
    if kind in ("f32", "bf16"):
        rng = np.random.default_rng(seed)
        counts = torch.from_numpy(rng.integers(2, 60, lib_size))
        return srp.build_precompute_paired(
            counts, d, 2094, 0.2, dtype=torch.float32 if kind == "f32"
            else torch.bfloat16)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal(
        (lib_size + 1, 2 * d)).astype(np.float32))
    table[-1] = 0
    return table.to(torch.bfloat16) if kind == "normal_bf16" else table


@pytest.mark.parametrize("kind", ["f32", "bf16", "normal", "normal_bf16"])
@pytest.mark.parametrize("k", [13, 21])
def test_embed_hits_paired_matches_jax(k, kind):
    """The dense plain version on JAX-staged hits against JAX
    embed_hits_paired on the same table (converted bit for bit)."""
    d = 48
    lib, planes, _, _ = _setup(k, d)
    index = jmem.build_library_index(lib.codes, k)
    hits_j, n_hits_j = jmem._read_hits_staged(
        tuple(jnp.asarray(p) for p in planes), index.words, index.table, k,
        index.bits, index.steps, index.packed)
    table = _dense_table(lib.size, d, kind)
    table_j = jnp.asarray(table.float().numpy())
    if table.dtype == torch.bfloat16:
        table_j = table_j.astype(jnp.bfloat16)
        assert torch.equal(paired_table_to_port(table_j).view(torch.int16),
                           table.view(torch.int16))
    e_fwd, e_rev = jembed.embed_hits_paired(hits_j, table_j, lib.size)
    fwd, rev = embed_hits_paired(torch.from_numpy(np.array(hits_j)),
                                 table, lib.size)
    rel = 2.0**-8 if kind == "normal_bf16" else 1e-6
    atol = rel * float(table.float().abs().max()) * int(np.max(n_hits_j))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(e_fwd), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(rev.numpy(), np.asarray(e_rev), rtol=1e-5,
                               atol=atol)
    assert int(np.max(n_hits_j)) > 0


@pytest.mark.parametrize("k", [13, 15, 16])
def test_membership_embed_dense_matches_pallas_merge_embed(k):
    """The dense form's plain version (through membership_embed_dense on
    CPU tensors, no launch counted) against merge_embed in interpret mode
    on one genuinely dense float32 table (normal entries, both halves
    nonzero in every column): hit counts bitwise, sums to rtol 1e-5, atol
    1e-6 * max|P| * hits; zero-hit rows exact zeros."""
    d = 64
    lib, planes, _, _ = _setup(k, d)
    table = _dense_table(lib.size, d, "normal", seed=k)
    p_ext = np.concatenate([table[: lib.size, :d].numpy(),
                            table[: lib.size, d:].numpy(),
                            np.zeros((1, d), np.float32)])
    e_f, e_r, nh = merge_embed(
        tuple(jnp.asarray(p) for p in planes),
        prepare_library(lib.codes, k),
        build_q_cat(jnp.asarray(p_ext), lib.size, tile=128),
        k=k, lib_size=lib.size, tile=128, block_rows=8, interpret=True)
    slots = torch.from_numpy(staged_planes_to_slots(planes, k))
    r = slots.shape[0]
    targets = torch.stack([2 * torch.arange(r), 2 * torch.arange(r) + 1],
                          dim=1)
    out = torch.zeros((2 * r, d))
    before = membership_embed_dense.launches
    n_hits = membership_embed_dense(
        slots, torch.from_numpy(lib.codes.astype(np.int64)), table, targets,
        out).numpy()
    assert membership_embed_dense.launches == before
    np.testing.assert_array_equal(n_hits, np.asarray(nh))
    atol = 1e-6 * float(table.abs().max()) * max(int(n_hits.max()), 1)
    np.testing.assert_allclose(out[0::2].numpy(), np.asarray(e_f)[:, :d],
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(out[1::2].numpy(), np.asarray(e_r)[:, :d],
                               rtol=1e-5, atol=atol)
    zero = n_hits == 0
    assert zero.any() and n_hits.max() > 0
    assert np.all(out.numpy()[0::2][zero] == 0)


def test_membership_embed_dense_refuses_bad_tables():
    staged = torch.zeros((2, 8), dtype=torch.int64)
    lib = torch.arange(5, dtype=torch.int64)
    targets = torch.zeros((2, 2), dtype=torch.int64)
    out = torch.zeros((4, 16))
    for table in (torch.zeros((6, 30)), torch.zeros((5, 32)),
                  torch.zeros((6, 32), dtype=torch.float16)):
        with pytest.raises(ValueError, match="p_pair"):
            membership_embed_dense(staged, lib, table, targets, out)


# ---- kernel C's dense form (csrc/membership_embed.cu), emulated ----


def _emulate_dense_kernel(staged, lib, tab, d, plan):
    """The dense form's schedule over the float32 values tab of a table:
    the first pass's hits of each row (slot order) and window bounds (the
    first hit of library row >= w * plan.window); then the sweep, block by
    block of plan.rows rows (a warp each), chunk by chunk of DENSE_COLS
    columns, window by window: each row's hits from its cursor to its
    bound, hit e added to part e % plan.parts of its row: its table row's
    chunk columns (halves swapped for a reverse-strand window) to that
    part's float32 sums in order; at the chunk's end the parts are added
    in part order. Returns (fwd, rev) float32, n_hits, and the (block,
    window) steps at which no row of the block had a hit."""
    r, h = staged.shape
    size = len(lib)
    rows_hits = []
    for i in range(r):
        row = staged[i]
        prev = np.concatenate([[PAD], row[:-1]])
        codes = row >> 1
        pos = _kernel_c_positions(lib, codes)
        hit = (row != PAD) & (row != prev) & (pos < size)
        hit &= lib[np.minimum(pos, max(size - 1, 0))] == codes if size \
            else False
        slots = np.nonzero(hit)[0]
        rows_hits.append((pos[slots], (row[slots] & 1) == 0))
    n_hits = np.array([len(j) for j, _ in rows_hits], np.int32)
    nw = plan.windows
    bounds = [np.concatenate([
        [0], np.searchsorted(j, plan.window * np.arange(1, nw)), [len(j)]])
        for j, _ in rows_hits]
    fwd = np.zeros((r, d), np.float32)
    rev = np.zeros((r, d), np.float32)
    empty = 0
    for b0 in range(0, r, plan.rows):
        block = range(b0, min(r, b0 + plan.rows))
        for c0 in range(0, d, DENSE_COLS):
            cols = slice(c0, min(d, c0 + DENSE_COLS))
            right = slice(d + cols.start, d + cols.stop)
            acc = np.zeros((len(block), plan.parts, 2, cols.stop - c0),
                           np.float32)
            cur = [0] * len(block)
            for w in range(nw):
                seen = 0
                for q, i in enumerate(block):
                    end = max(cur[q], int(bounds[i][w + 1]))
                    for e in range(cur[q], end):
                        j, swap = rows_hits[i][0][e], rows_hits[i][1][e]
                        halves = [tab[j, cols], tab[j, right]]
                        if swap:
                            halves.reverse()
                        acc[q, e % plan.parts, 0] += halves[0]
                        acc[q, e % plan.parts, 1] += halves[1]
                    seen += end - cur[q]
                    cur[q] = end
                empty += not seen
            for q, i in enumerate(block):
                sums = acc[q, 0]
                for part in range(1, plan.parts):
                    sums = sums + acc[q, part]
                fwd[i, cols] = sums[0]
                rev[i, cols] = sums[1]
    return fwd, rev, n_hits, empty


@pytest.mark.parametrize("d,kind,rows,window", [
    (40, "f32", 6, None), (100, "bf16", 6, None), (512, "normal", 3, None),
    (1100, "normal_bf16", 2, None), (1100, "normal", 2, None),
    # windows of 7 library rows: each row's hits cross many window edges,
    # and rows of a block share library rows on both sides of them
    (64, "normal", 6, 7),
    # windows of 2 library rows: windows whose blocks stage no hit
    (32, "f32", 5, 2),
    # 7 rows in blocks of 4: the last ends early, at a padding row with no
    # hit
    (100, "normal", 7, 40),
])
def test_dense_kernel_schedule_matches_plain(d, kind, rows, window):
    """The dense form's schedule (dense_plan, emulated) reproduces its
    plain version: hit counts bitwise, sums to rtol 1e-5, atol 1e-6 *
    max|P| * hits (2^-8 for a bfloat16 table with no sign structure, where
    the plain version rounds gl +- gr), over blocks of one and several
    rows, rows of 2 and 4 parts, column chunks past DENSE_COLS (1,100
    columns), windows that cut each row's hits, windows with no hit, a
    block whose rows end early, repeated slots and a row of padding."""
    rng = np.random.default_rng(d)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 2400, rows)
    bases = torch.from_numpy(np.stack([genome[s : s + 2400] for s in starts]))
    from fedrann_tpu_torch.kmers.codec import canonical_sample
    from fedrann_tpu_torch.kmers.library import build_library
    from fedrann_tpu_torch.kmers.membership import select_candidates
    slots = canonical_sample(bases, 13, 9, sample_threshold(0.5), False)
    staged, _ = select_candidates(slots, 1100, False, None)
    staged[0, 10:40] = staged[0, 10]
    staged[-1] = PAD
    library = build_library([staged], 2, 0.5, 9)
    table = _dense_table(library.size, d, kind, seed=d)
    targets = torch.stack([2 * torch.arange(rows), 2 * torch.arange(rows) + 1],
                          dim=1)
    out = torch.zeros((2 * rows, d))
    n_hits = membership_embed_dense(staged, library.codes, table, targets,
                                    out)
    tab = table.float().numpy()
    plan = dense_plan(rows, d, table.element_size(), library.size, 1,
                      window=window)
    fwd, rev, n_emul, empty = _emulate_dense_kernel(
        staged.numpy(), library.codes.numpy(), tab, d, plan)
    np.testing.assert_array_equal(n_emul, n_hits.numpy())
    assert n_hits[:-1].min() > 0 and n_hits[-1] == 0
    if window == 2:
        assert empty > 0
    if rows == 7:
        assert rows % plan.rows and plan.rows > 1
    assert plan.parts == (4 if rows <= 3 else 2)
    if window is not None:
        assert plan.windows > 10
    rel = 2.0**-8 if kind == "normal_bf16" else 1e-6
    atol = rel * float(np.abs(tab).max()) * int(n_hits.max())
    np.testing.assert_allclose(fwd, out[0::2].numpy(), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(rev, out[1::2].numpy(), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [1, 13, 40, 256, 512, 1100, 20000])
def test_dense_plan_limits(d, itemsize):
    """dense_plan's limits: loads of at most 16 bytes of entries that
    divide d (one entry for a table off 16 bytes; 16 bytes at d = 512), a
    chunk of DENSE_COLS columns 16 of each half a lane, blocks of
    DENSE_BLOCK_WARPS warps (rows x parts), parts doubled up to
    DENSE_PARTS_MAX while the rows' warps stay within half of a 132-SM
    card's DENSE_WARPS_PER_SM; windows of about DENSE_WINDOW_BYTES that
    cover the library; lag DENSE_LAG."""
    assert DENSE_COLS == 32 * 16
    for rows in (1, 296, 2048, 100_000):
        for aligned in (True, False):
            for lib_size in (0, 1, 161_372):
                plan = dense_plan(rows, d, itemsize, lib_size, 132, aligned)
                assert plan.rows * plan.parts == DENSE_BLOCK_WARPS
                assert plan.parts in (1, 2, 4) and plan.parts <= \
                    DENSE_PARTS_MAX
                assert rows * plan.parts <= 132 * DENSE_WARPS_PER_SM \
                    or plan.parts == 1
                assert plan.parts == DENSE_PARTS_MAX or \
                    2 * rows * plan.parts > 132 * DENSE_WARPS_PER_SM
                assert plan.per * itemsize <= 16 and d % plan.per == 0
                assert 16 % plan.per == 0
                assert aligned or plan.per == 1
                assert (plan.windows - 1) * plan.window < max(lib_size, 1)
                assert plan.windows * plan.window >= lib_size
                width = 2 * min(d, DENSE_COLS) * itemsize
                assert plan.window * width <= max(
                    DENSE_WINDOW_BYTES[itemsize], width)
                assert (plan.window + 1) * width > DENSE_WINDOW_BYTES[itemsize]
                assert plan.lag == DENSE_LAG >= 1
    if d == 512:
        plan = dense_plan(2048, d, itemsize, 161_372, 132)
        assert (plan.per * itemsize, plan.rows, plan.parts) == (16, 4, 1)
    if d == 256:
        plan = dense_plan(296, d, itemsize, 17_903, 132)
        assert (plan.rows, plan.parts) == (1, 4)
