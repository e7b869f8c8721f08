"""fedrann_tpu_torch projection and membership+embed (the plain version of
kernel C) against the JAX functions and the Pallas `merge_embed` kernel in
interpret mode.

SRP signs and magnitudes are bitwise. Hit rows are bitwise; embedding rows
agree to rtol 1e-5 with atol 1e-6 * max|mags| * hits, because the f32 sums
run in another order (the JAX path sums in a sum/difference basis, the
Pallas kernel row by row)."""

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
    signs_to_port,
    staged_planes_to_slots,
)
from fedrann_tpu_torch.io.fastx import FastxRecord  # noqa: E402
from fedrann_tpu_torch.io.packing import pack_reads  # noqa: E402
from fedrann_tpu_torch.kmers.codec import sample_threshold  # noqa: E402
from fedrann_tpu_torch.kmers.membership import read_hits_staged  # noqa: E402
from fedrann_tpu_torch.project import srp  # noqa: E402
from fedrann_tpu_torch.project.embed import membership_embed  # noqa: E402
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
