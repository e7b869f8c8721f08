"""fedrann_tpu_torch k-mer codec (the plain version of kernel A) against the
JAX codec, the numpy oracle and the Pallas codec kernel in interpret mode,
bitwise, on the same numpy inputs."""

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
from fedrann_tpu.kmers import codec as jcodec  # noqa: E402
from fedrann_tpu_torch.kmers import codec  # noqa: E402
from pallas_kernels import canonical_and_sample  # noqa: E402

SEED, FRACTION = 602, 0.3


def _bases(rng, r=12, length=300):
    """Random reads with mid-read N bases (code 4) and one all-N row."""
    b = rng.integers(0, 4, size=(r, length)).astype(np.uint8)
    b[rng.random((r, length)) < 0.02] = 4
    b[3] = 4
    return b


def _jax_canonical(bases, k):
    canon_w, is_fwd, valid = jcodec.canonical_window_codes(
        jnp.asarray(bases), k)
    canon = jcodec.words_to_u64(tuple(np.asarray(w) for w in canon_w))
    return canon, np.asarray(is_fwd), np.asarray(valid)


@pytest.mark.parametrize("k", [13, 15, 16, 21, 31])
def test_canonical_window_codes_bitwise(k):
    bases = _bases(np.random.default_rng(k))
    canon_j, fwd_j, valid_j = _jax_canonical(bases, k)
    canon, fwd, valid = codec.canonical_window_codes(torch.from_numpy(bases), k)
    canon, fwd, valid = canon.numpy(), fwd.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid, valid_j)
    np.testing.assert_array_equal(canon[valid], canon_j[valid].astype(np.int64))
    assert np.all(canon[~valid] == codec.PAD_SLOT)
    np.testing.assert_array_equal(fwd[valid], fwd_j[valid])


@pytest.mark.parametrize("k", [13, 15, 16, 21, 31])
def test_canonical_sample_matches_jax_selection(k):
    """Slots are set exactly where select_candidates' candidate mask is."""
    bases = _bases(np.random.default_rng(100 + k))
    canon_j, fwd_j, valid_j = _jax_canonical(bases, k)
    words = jcodec.u64_to_words(canon_j, k)
    hashed = np.asarray(jcodec.sample_hash32(
        tuple(jnp.asarray(w) for w in words), SEED))
    thr = codec.sample_threshold(FRACTION)
    cand = valid_j & (hashed < np.uint32(thr))
    want = np.where(cand, (canon_j.astype(np.int64) << 1)
                    | fwd_j.astype(np.int64), codec.PAD_SLOT)
    got = codec.canonical_sample(torch.from_numpy(bases), k, SEED, thr, False)
    np.testing.assert_array_equal(got.numpy(), want)
    every = codec.canonical_sample(torch.from_numpy(bases), k, SEED, thr, True)
    np.testing.assert_array_equal(every.numpy() != codec.PAD_SLOT, valid_j)


@pytest.mark.parametrize("k", [13, 15, 16])
def test_canonical_sample_matches_pallas_kernel(k):
    """The Pallas codec kernel (k <= 16, interpret mode) marks the same
    windows and codes; its output is L wide with k-1 invalid columns."""
    bases = _bases(np.random.default_rng(200 + k), r=16, length=256)
    thr = codec.sample_threshold(FRACTION)
    canon_p, keep_p = canonical_and_sample(jnp.asarray(bases), k, SEED, thr,
                                           interpret=True)
    w = bases.shape[1] - k + 1
    canon_p = np.asarray(canon_p)[:, :w].astype(np.int64)
    keep_p = np.asarray(keep_p)[:, :w].astype(bool)
    got = codec.canonical_sample(torch.from_numpy(bases), k, SEED, thr,
                                 False).numpy()
    np.testing.assert_array_equal(got != codec.PAD_SLOT, keep_p)
    np.testing.assert_array_equal(got[keep_p] >> 1, canon_p[keep_p])


def test_hashes_bitwise():
    rng = np.random.default_rng(5)
    x32 = rng.integers(0, 2**32, size=4000, dtype=np.uint64)
    got = codec.fmix32(torch.from_numpy(x32.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, oracle.fmix32(x32.astype(np.uint32)))
    for k in (13, 21, 31):
        codes = rng.integers(0, 1 << (2 * k), size=4000, dtype=np.uint64)
        got = codec.sample_hash32(torch.from_numpy(codes.astype(np.int64)),
                                  SEED).numpy()
        np.testing.assert_array_equal(got, oracle.sample_hash32(codes, SEED))
        dev = np.asarray(jcodec.sample_hash32(
            tuple(jnp.asarray(w) for w in jcodec.u64_to_words(codes, k)),
            SEED))
        np.testing.assert_array_equal(got, dev)
    x64 = rng.integers(0, 2**64 - 1, size=4000, dtype=np.uint64)
    got = codec.splitmix64(torch.from_numpy(x64.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), oracle.splitmix64(x64))
    np.testing.assert_array_equal(
        got.view(np.uint64), np.asarray(jcodec.splitmix64(jnp.asarray(x64))))
