"""fedrann_tpu_torch k-mer codec (the plain version of kernel A) against the
JAX codec, the numpy oracle and the Pallas codec kernel in interpret mode,
bitwise, on the same numpy inputs; and a numpy emulation of the window-code
function that kernels A and B share (csrc/window_codes.cuh), held against
all three."""

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
WINDOW_CHUNKS = (1024 + 32) // 16  # window_codes.cuh: a block and its halo


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


# ---- the window-code function of csrc/window_codes.cuh, emulated ----

_M32 = np.uint64(0xFFFFFFFF)
_BREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint64)


def _brev(x, bits):
    """__brev (bits = 32) / __brevll (64) of uint64 values below 2^bits."""
    out = np.zeros_like(x)
    for byte in range(bits // 8):
        out |= _BREV8[(x >> np.uint64(8 * byte)) & np.uint64(0xFF)] << \
            np.uint64(bits - 8 - 8 * byte)
    return out


def _funnel(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low 32 bits of (hi:lo) >> s."""
    return (((hi << np.uint64(32)) | lo) >> s) & _M32


def _fmix32(x):
    x = x & _M32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & _M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & _M32
    return x ^ (x >> np.uint64(16))


def _byte_chunks(bases):
    """The byte source's chunks (RowSource<SRC_BYTES>: load_window_chunk,
    pack_chunk) of block b: (stream words, 16-bit invalid halves), each
    (R, WINDOW_CHUNKS), for b given."""
    u = np.uint64
    r, length = bases.shape

    def chunks(b):
        off = 1024 * b
        c = np.full((r, 16 * WINDOW_CHUNKS), 4, np.uint8)
        n = min(length - off, 16 * WINDOW_CHUNKS)
        c[:, :n] = bases[:, off : off + n]
        c = c.reshape(r, WINDOW_CHUNKS, 16)
        stream = np.bitwise_or.reduce(
            (c & 3).astype(u) << (2 * np.arange(16, dtype=u)), axis=2)
        half = np.bitwise_or.reduce(
            (c >= 4).astype(u) << np.arange(16, dtype=u), axis=2)
        return stream, half
    return chunks


def _past_mask(left):
    """window_codes.cuh past_mask: the invalid mask of 16 bases of which
    the first `left` lie in the row."""
    shift = np.clip(left, 0, 16).astype(np.uint64)
    return np.where(left >= 16, 0, np.where(
        left <= 0, 0xFFFF, (np.uint64(0xFFFF) << shift) & np.uint64(0xFFFF))
    ).astype(np.uint64)


def packed_chunks(packed, length, lengths=None, valid=None):
    """RowSource<SRC_PACKED> (with `lengths`) or <SRC_BITS> (with `valid`)
    fetch in numpy: chunk c of block b is stream word q = 64 b + c, the
    row's bytes [4q, 4q + 4) little-endian, 0 past its stride; its mask
    the bases from the row's length (packed) or the inverted valid bytes
    2q and 2q + 1 (0 past the valid row), and the bases past L."""
    u = np.uint64
    r, stride = packed.shape

    def byte_at(plane, idx):
        width = plane.shape[1]
        got = plane[:, np.minimum(idx, width - 1)].astype(u)
        return np.where(idx[None, :] < width, got, u(0))

    def chunks(b):
        q = 64 * b + np.arange(WINDOW_CHUNKS)
        word = np.zeros((r, WINDOW_CHUNKS), u)
        for j in range(4):
            word |= byte_at(packed, 4 * q + j) << u(8 * j)
        if lengths is not None:
            left = np.minimum(lengths.astype(np.int64), length)[:, None]
            return word, _past_mask(left - 16 * q[None, :])
        bits = byte_at(valid, 2 * q) | (byte_at(valid, 2 * q + 1) << u(8))
        return word, ((~bits) & u(0xFFFF)) | _past_mask(
            length - 16 * q[None, :])
    return chunks


def emulate_window_slots(bases, k, seed, threshold, keep_all, threads=256,
                         chunks=None):
    """csrc/window_codes.cuh `window_slots` in numpy, block by block as
    kernels A and B run it: each 1024-window block stages 66 chunks of 16
    bases (its bases and the k - 1 halo, INVALID past the row), packs them
    into 32-bit words of a 2-bit LSB-first stream and 16-bit halves of an
    invalid mask, skips a block whose bases are all INVALID, and gives
    thread t's windows PER * t + i: v by funnel shifts of the stream words
    its first window shares, rc = ~v & mask, code = pairrev(v) >> (B - 2k)
    (bit reversal, then each pair's bits swapped back), the validity test
    on the mask words, the sample_hash32 filter. Returns the (R, W) slots.
    `chunks` (b -> the stream words and invalid halves of block b's
    chunks) stands in for the byte source's: packed_chunks gives the
    packed and bits sources' (`bases` then gives only the shape).

    Breaking it fails the tests below: staging 64 chunks (no halo) leaves
    every block's last k - 1 windows INVALID, and dropping the pair swap
    gives wrong codes (both checked on a copy of this file)."""
    u = np.uint64
    per = 1024 // threads
    r, length = bases.shape
    w = length - k + 1
    n_blocks = -(-w // 1024)
    bits = 64 if k > 16 else 32
    s1, s2 = codec.seed_mix32(seed)
    j = np.arange(1024)
    j0 = j // per * per  # each window's thread's first window
    s = (2 * ((j0 & 15) + j % per)).astype(u)
    t = ((j0 & 31) + j % per).astype(u)
    mask = u((1 << bits) - 1) >> u(bits - 2 * k)
    out = np.full((r, n_blocks * 1024), codec.PAD_SLOT, np.int64)
    chunks = chunks or _byte_chunks(bases)
    for b in range(n_blocks):
        off = 1024 * b
        stream, half = chunks(b)
        invalid = half[:, 0::2] | (half[:, 1::2] << u(16))
        live = (half != 0xFFFF).any(axis=1)  # __syncthreads_or
        q = j0 >> 4
        x = _funnel(stream[:, q], stream[:, q + 1], s)
        if k > 16:
            x |= _funnel(stream[:, q + 1], stream[:, q + 2], s) << u(32)
        x &= mask
        rc = ~x & mask
        p = _brev(x, bits)
        p = ((p >> u(1)) & u(0x5555555555555555)) | (
            (p & u(0x5555555555555555)) << u(1))
        code = p >> u(bits - 2 * k)
        is_fwd = code <= rc
        canon = np.where(is_fwd, code, rc)
        bad = _funnel(invalid[:, j0 >> 5], invalid[:, (j0 >> 5) + 1], t)
        valid = (off + j < w) & ((bad & u((1 << k) - 1)) == 0)
        keep = valid
        if not keep_all:
            h1 = _fmix32(canon ^ u(s1))
            h2 = _fmix32((canon >> u(32)) ^ u(s2) ^ h1)
            keep = valid & (_fmix32(h1 ^ h2) < threshold)
        slot = ((canon << u(1)) | is_fwd).astype(np.int64)
        out[:, off : off + 1024] = np.where(
            live[:, None] & keep, slot, codec.PAD_SLOT)
    return out[:, :w]


def _revcomp(b):
    return (3 - b)[::-1]


def edge_bases(k, rows=9, length=3055, seed=0):
    """Reads whose windows cross every case window_slots distinguishes, at
    an L that is no multiple of 16 and a W that is no multiple of 1024:
    row 0 a read ending mid-block (INVALID after it); row 1 all INVALID;
    row 2 INVALID bases on block edges and inside block 0's halo; row 3
    even-k palindromes (a k-mer equal to its reverse complement) planted
    across block edges; row 4 a block all INVALID but for its halo; row 5
    a read ending exactly at a block edge, so its last block is all
    INVALID and skipped; the rest random with 2% INVALID."""
    rng = np.random.default_rng(seed + k)
    b = rng.integers(0, 4, size=(rows, length)).astype(np.uint8)
    b[rng.random((rows, length)) < 0.02] = 4
    b[0, 1500:] = 4
    b[1] = 4
    b[2, [1023, 1024, 2047, 2048, 1024 + max(k - 2, 0) // 2]] = 4
    if k % 2 == 0:
        for start in (10, 1024 - k // 2, 2048 - k + 3, length - k):
            half = rng.integers(0, 4, k // 2).astype(np.uint8)
            b[3, start : start + k] = np.concatenate([half, _revcomp(half)])
            assert np.array_equal(b[3, start : start + k],
                                  _revcomp(b[3, start : start + k]))
    b[4, 1024:2048] = 4
    b[5, 2048:] = 4
    return b


WINDOW_KS = [1, 2, 13, 15, 16, 17, 21, 31]


@pytest.mark.parametrize("threads", [256, 1024])
@pytest.mark.parametrize("k", WINDOW_KS)
def test_window_slots_emulation_matches_plain(k, threads):
    """The window-code function, bitwise against kernel A's plain version
    with and without sampling, for both thread layouts of kernel B."""
    bases = edge_bases(k)
    thr = codec.sample_threshold(FRACTION)
    for keep_all in (False, True):
        got = emulate_window_slots(bases, k, SEED, thr, keep_all, threads)
        want = codec._canonical_sample_plain(torch.from_numpy(bases), k,
                                             SEED, thr, keep_all).numpy()
        np.testing.assert_array_equal(got, want)
    assert (got[1] == codec.PAD_SLOT).all()
    assert (got[0, 1500:] == codec.PAD_SLOT).all()
    assert (got[0, : 1500 - k + 1] != codec.PAD_SLOT).sum() > 0


@pytest.mark.parametrize("k", [13, 15, 16, 17, 21, 31])
def test_window_slots_emulation_matches_jax(k):
    """The same emulation against the JAX codec + sample_hash32: slots
    where select_candidates' candidate mask is set, canonical codes and
    strands (palindromes forward)."""
    bases = edge_bases(k, seed=7)
    canon_j, fwd_j, valid_j = _jax_canonical(bases, k)
    words = jcodec.u64_to_words(canon_j, k)
    hashed = np.asarray(jcodec.sample_hash32(
        tuple(jnp.asarray(w) for w in words), SEED))
    thr = codec.sample_threshold(FRACTION)
    cand = valid_j & (hashed < np.uint32(thr))
    want = np.where(cand, (canon_j.astype(np.int64) << 1)
                    | fwd_j.astype(np.int64), codec.PAD_SLOT)
    np.testing.assert_array_equal(
        emulate_window_slots(bases, k, SEED, thr, False), want)
    every = emulate_window_slots(bases, k, SEED, thr, True)
    np.testing.assert_array_equal(every != codec.PAD_SLOT, valid_j)
    if k % 2 == 0:  # the planted palindromes are valid, forward windows
        assert (every[3, [10, 1024 - k // 2]] & 1 == 1).all()


@pytest.mark.parametrize("k", [13, 15, 16])
def test_window_slots_emulation_matches_pallas_kernel(k):
    """Against the Pallas codec kernel (k <= 16, interpret mode): the same
    windows kept, the same codes."""
    bases = edge_bases(k, rows=6, length=2101, seed=9)
    thr = codec.sample_threshold(FRACTION)
    canon_p, keep_p = canonical_and_sample(jnp.asarray(bases), k, SEED, thr,
                                           interpret=True)
    w = bases.shape[1] - k + 1
    canon_p = np.asarray(canon_p)[:, :w].astype(np.int64)
    keep_p = np.asarray(keep_p)[:, :w].astype(bool)
    got = emulate_window_slots(bases, k, SEED, thr, False)
    np.testing.assert_array_equal(got != codec.PAD_SLOT, keep_p)
    np.testing.assert_array_equal(got[keep_p] >> 1, canon_p[keep_p])


@pytest.mark.parametrize("source", ["packed", "bits"])
@pytest.mark.parametrize("k", [1, 13, 16, 17, 31])
@pytest.mark.parametrize("length", [4096, 3055, 3057])
def test_window_slots_emulation_on_packed_sources(source, k, length):
    """The window-code function on the packed and bits sources (their
    loaders emulated: stream words from the packer's bytes, 0 past a row
    of 1,024, 764 or 765 bytes; masks from the lengths or the inverted
    valid bits and the row's end) against unpack + kernel A's plain
    version, bitwise, with and without sampling."""
    from fedrann_tpu_torch.io.packing import bit_pack

    rng = np.random.default_rng(length + k)
    if source == "packed":  # prefix rows: valid up to each row's length
        lengths = rng.integers(0, length + 1, 9).astype(np.int32)
        lengths[:6] = (length, length - 1, 0, 1, 2048, 1500)
        bases = rng.integers(0, 4, (9, length)).astype(np.uint8)
        bases[np.arange(length)[None, :] >= lengths[:, None]] = 4
    else:
        bases = edge_bases(k, length=length)
    packed, valid = bit_pack(bases)
    chunks = (packed_chunks(packed, length, lengths=lengths)
              if source == "packed" else
              packed_chunks(packed, length, valid=valid))
    thr = codec.sample_threshold(FRACTION)
    for keep_all in (False, True):
        got = emulate_window_slots(np.zeros_like(bases), k, SEED, thr,
                                   keep_all, chunks=chunks)
        want = codec._canonical_sample_plain(torch.from_numpy(bases), k,
                                             SEED, thr, keep_all).numpy()
        np.testing.assert_array_equal(got, want)
    assert (got != codec.PAD_SLOT).any()


# ---- the packer's 2-bit form: unpack_bases[_len] ----


@pytest.mark.parametrize("length", [1, 7, 16, 300, 1029])
def test_unpack_bases_bitwise(length):
    """unpack_bases and unpack_bases_len against JAX's, bitwise, on the
    2-bit planes of rows with mid-read INVALID bases (valid bits) and of
    prefix rows (lengths, some past L or 0), L a multiple of 4 and 8 or
    not."""
    from fedrann_tpu_torch.io.packing import bit_pack

    rng = np.random.default_rng(length)
    bases = _bases(rng, r=9, length=length)
    packed, valid = bit_pack(bases)
    got = codec.unpack_bases(torch.from_numpy(packed),
                             torch.from_numpy(valid), length)
    want = np.asarray(jcodec.unpack_bases(jnp.asarray(packed),
                                          jnp.asarray(valid), length))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bases)
    lengths = rng.integers(0, length + 3, 9).astype(np.int32)
    lengths[:2] = (0, length)
    got = codec.unpack_bases_len(torch.from_numpy(packed),
                                 torch.from_numpy(lengths), length)
    want = np.asarray(jcodec.unpack_bases_len(
        jnp.asarray(packed), jnp.asarray(lengths), length))
    np.testing.assert_array_equal(got.numpy(), want)
    chunk = codec.PackedChunk(torch.from_numpy(packed), length,
                              lengths=torch.from_numpy(lengths))
    assert chunk.source == "packed" and chunk.shape == (9, length)
    np.testing.assert_array_equal(chunk[2:5].unpack().numpy(), want[2:5])


def test_packed_chunk_refuses_a_bad_form():
    packed = torch.zeros((4, 25), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lengths or valid_bits"):
        codec.PackedChunk(packed, 100)
    with pytest.raises(ValueError, match="packed must be"):
        codec.PackedChunk(packed, 101,
                          lengths=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="valid_bits must be"):
        codec.PackedChunk(packed, 100,
                          valid_bits=torch.zeros((4, 12), dtype=torch.uint8))
