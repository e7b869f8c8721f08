"""fedrann_tpu_torch's imports, dense paired projections and recall scoring
against the JAX package on the same inputs: the reference library's codes,
counts and permutation and the permuted projection bitwise (both golden
datasets and a library file of edge cases), `build_precompute_paired` in
float32 and bfloat16 and `pair_projection` bitwise, the JAX-to-port table
converter bit for bit, and `neighbor_recall`'s report equal."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fedrann_tpu import compat as jcompat
from fedrann_tpu import eval as jeval
from fedrann_tpu import oracle
from fedrann_tpu.project import srp as jsrp
from fedrann_tpu_torch import compat, eval as port_eval
from fedrann_tpu_torch.convert import paired_table_to_port
from fedrann_tpu_torch.project import srp
from fedrann_tpu_torch.sim import simulate_reads

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench", "golden")


def _golden(name):
    data = os.path.join(GOLDEN, name)
    meta = os.path.join(data, "meta.json")
    k = json.load(open(meta))["k"] if os.path.exists(meta) else 15
    return data, k


@pytest.mark.parametrize("name", ["data", "data_k21"])
def test_golden_library_and_projection_match_jax(name):
    data, k = _golden(name)
    lib_path = os.path.join(data, "fwd_kmer_library.fasta")
    lib, perm = compat.load_reference_library_mapping(lib_path, k)
    lib_j, perm_j = jcompat.load_reference_library_mapping(lib_path, k)
    codes, counts = lib.numpy()
    np.testing.assert_array_equal(codes, lib_j.codes)
    np.testing.assert_array_equal(counts, lib_j.counts)
    np.testing.assert_array_equal(perm, perm_j)
    assert lib.size > 10_000
    npz = os.path.join(data, "precompute.npz")
    p_flat = compat.load_reference_precompute(npz, perm)
    np.testing.assert_array_equal(
        p_flat, jcompat.load_reference_precompute(npz, perm_j))
    assert p_flat.shape == (2 * lib.size + 1, 256)
    np.testing.assert_array_equal(
        srp.pair_projection(torch.from_numpy(p_flat)).numpy(),
        jsrp.pair_projection(p_flat, xp=np))
    np.testing.assert_array_equal(compat.load_reference_library(
        lib_path, k).codes.numpy(), lib.codes.numpy())


def test_mismatched_permutation_raises():
    data, k = _golden("data")
    _, perm = compat.load_reference_library_mapping(
        os.path.join(data, "fwd_kmer_library.fasta"), k)
    with pytest.raises(ValueError, match="mismatch"):
        compat.load_reference_precompute(
            os.path.join(data, "precompute.npz"), perm + 10**6)


@pytest.mark.parametrize("k", [5, 21])
def test_library_edge_entries_match_jax(tmp_path, k):
    """Entries listed in flipped (non-canonical) form, duplicates in both
    forms (the first in the file wins), entries of the wrong length or with
    an N, and headers that are not integers; codes, counts and the
    permutation equal the JAX loader's bitwise."""
    rng = np.random.default_rng(k)
    kmers = ["".join("ACGT"[b] for b in rng.integers(0, 4, k))
             for _ in range(40)]
    comp = str.maketrans("ACGT", "TGCA")
    lines = []
    for i, s in enumerate(kmers):
        lines += [f">{i + 2}", s]
        if i % 5 == 0:   # the same k-mer again, reverse complemented
            lines += [f">{100 + i}", s.translate(comp)[::-1]]
    lines += [">7", kmers[3][:-1], ">8", "N" + kmers[4][1:], ">x y",
              kmers[6][::-1], ">1e3", "A" * k]
    path = tmp_path / "lib.fasta"
    path.write_text("\n".join(lines) + "\n")
    lib, perm = compat.load_reference_library_mapping(str(path), k)
    lib_j, perm_j = jcompat.load_reference_library_mapping(str(path), k)
    codes, counts = lib.numpy()
    np.testing.assert_array_equal(codes, lib_j.codes)
    np.testing.assert_array_equal(counts, lib_j.counts)
    np.testing.assert_array_equal(perm, perm_j)
    flipped = perm[: lib.size] >= perm[-1] // 2  # the sentinel: 2 n_file
    assert flipped.any() and not flipped.all()
    assert 1 in counts


def test_empty_library_file_matches_jax(tmp_path):
    path = tmp_path / "lib.fasta"
    path.write_text(">3\nACG\n")
    lib, perm = compat.load_reference_library_mapping(str(path), 5)
    lib_j, perm_j = jcompat.load_reference_library_mapping(str(path), 5)
    assert lib.size == 0 == lib_j.size
    np.testing.assert_array_equal(perm, perm_j)


@pytest.mark.parametrize("k", [13, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_precompute_paired_bitwise(k, dtype):
    """A sampled library's counts at k; the dense paired table (two chunk
    sizes) equals the JAX package's bit for bit, through
    paired_table_to_port; in float32 it is the sign table's reconstruction
    sign * mags[j] bitwise."""
    sim = simulate_reads(genome_length=20_000, coverage=5,
                         mean_read_length=1500, seed=k)
    lib = oracle.build_library(sim.sequences, k, 2, 0.2, 602)
    counts = lib.counts.astype(np.int64)
    for chunk in (1 << 16, 999):
        want = paired_table_to_port(jsrp.build_precompute_paired(
            jnp.asarray(counts.astype(np.int32)), 96, 2094, None,
            chunk=chunk, dtype=getattr(jnp, dtype)))
        got = srp.build_precompute_paired(
            torch.from_numpy(counts), 96, 2094, None, chunk=chunk,
            dtype=getattr(torch, dtype))
        assert got.dtype == want.dtype and got.shape == (lib.size + 1, 192)
        assert torch.equal(got.view(torch.int16 if dtype == "bfloat16"
                                    else torch.int32),
                           want.view(torch.int16 if dtype == "bfloat16"
                                     else torch.int32))
    if dtype == "float32":
        from fedrann_tpu_torch.project.embed import _unpack_sign_rows

        signs, mags = srp.build_precompute_signs(torch.from_numpy(counts),
                                                 96, 2094)
        assert torch.equal(_unpack_sign_rows(signs, 192) * mags[:, None],
                           got)


def test_build_precompute_paired_refuses_other_dtypes():
    with pytest.raises(ValueError, match="bfloat16"):
        srp.build_precompute_paired(torch.ones(4, dtype=torch.int64), 8, 1,
                                    dtype=torch.float16)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_paired_table_to_port_round_trip(dtype):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((33, 18)).astype(np.float32).astype(dtype)
    table[3, 4] = -0.0
    got = paired_table_to_port(jnp.asarray(table))
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.bfloat16)
    bits = np.asarray(table).view(np.int32 if dtype == np.float32
                                  else np.int16)
    np.testing.assert_array_equal(
        got.view(torch.int32 if dtype == np.float32 else torch.int16)
        .numpy(), bits)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paired_table_to_port(np.zeros((2, 2), np.float64))


def test_neighbor_recall_matches_jax(tmp_path):
    """The port's recall scoring against the JAX package's on the golden
    reference table and a copy with some neighbors, orientations and
    distances changed and one query dropped, at the k the golden runs
    score."""
    ref_path = os.path.join(GOLDEN, "data", "overlaps_ref.tsv")
    with open(ref_path) as f:
        lines = f.readlines()
    changed = [lines[0]]
    for i, line in enumerate(lines[1:]):
        q, qo, t, to, rank, dist = line.rstrip("\n").split("\t")
        if q == lines[1].split("\t")[0]:
            continue
        if i % 7 == 0:
            t = "nobody"
        elif i % 5 == 0:  # the neighbor, in the other orientation
            to = "-" if to == "+" else "+"
        changed.append("\t".join([q, qo, t, to, rank,
                                  f"{float(dist) + 1e-3 * (i % 3):.6f}"])
                       + "\n")
    cand = tmp_path / "cand.tsv"
    cand.write_text("".join(changed))
    got = port_eval.neighbor_recall(
        port_eval.OverlapTable.read(ref_path),
        port_eval.OverlapTable.read(str(cand)), k=20)
    want = jeval.neighbor_recall(
        jeval.OverlapTable.read(ref_path),
        jeval.OverlapTable.read(str(cand)), k=20)
    assert str(got) == str(want)
    assert got.recall_at_k == want.recall_at_k
    assert got.distance_mae == want.distance_mae
    assert got.query_coverage == want.query_coverage < 1.0
    # the orientation edits count as misses, as they do in the JAX package
    assert got.recall_at_k < jeval.neighbor_recall(
        jeval.OverlapTable.read(ref_path), jeval.OverlapTable.read(str(cand)),
        k=20, match_orientation=False).recall_at_k
