"""The sign table of fedrann_tpu_torch's projection (the plain version of
K5, csrc/srp_signs.cu) against the JAX `build_precompute_signs`, and the
dense paired table (the plain version of K8, the same source) against
the JAX `build_precompute_paired`, bitwise, across densities, library
sizes, widths, chunk sizes and both table dtypes."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu.project import srp as jsrp
from fedrann_tpu_torch.convert import paired_table_to_port, signs_to_port
from fedrann_tpu_torch.project import srp

CHUNK = 16


@pytest.mark.parametrize("d", [8, 512])
@pytest.mark.parametrize("lib_size", [11, 37])
@pytest.mark.parametrize("density", [None, 0.5, 1.0])
def test_sign_table_bitwise(density, lib_size, d):
    """Densities 1/sqrt(2L) (None), 0.5 and 1.0 (every field nonzero); L
    below one 16-field word's worth of rows (11) and L not a multiple of
    the chunk (37 over chunks of 16); d = 8 (one word a row) and 512."""
    counts = np.random.default_rng(lib_size + d).integers(
        2, 50, lib_size).astype(np.int32)
    signs_j, mags_j = signs_to_port(*jsrp.build_precompute_signs(
        jnp.asarray(counts), d, 2094, density, chunk=CHUNK))
    signs, mags = srp.build_precompute_signs(
        torch.from_numpy(counts.astype(np.int64)), d, 2094, density,
        chunk=CHUNK)
    assert signs.shape == (lib_size + 1, (2 * d + 15) // 16)
    np.testing.assert_array_equal(signs.numpy(), signs_j)
    # the magnitudes are torch ops beside the table: bitwise but where a
    # count equals 2L, whose ICF is the float64 log of a number within
    # 1e-13 of 1 (~1e-14), which XLA's log and torch's round apart
    np.testing.assert_allclose(mags.numpy(), mags_j, rtol=0, atol=1e-15)
    exact = counts != 2 * lib_size
    np.testing.assert_array_equal(mags.numpy()[:-1][exact], mags_j[:-1][exact])
    if density == 1.0:  # every field of a real row is +1 or -1
        codes = (signs[:lib_size].numpy().view(np.uint32)[..., None]
                 >> (2 * np.arange(16, dtype=np.uint32))) & 3
        assert set(np.unique(codes[:, :, : 2 * d].reshape(-1))) <= {1, 2}
    assert not signs[lib_size].any()


def test_sign_table_plain_is_the_table():
    """sign_table on the CPU is sign_table_plain, whatever the chunk."""
    mix = srp.seed_mix_of(7)
    want = srp.sign_table_plain(29, 20, mix, 0.3, torch.device("cpu"), 8)
    assert torch.equal(srp.sign_table(29, 20, mix, 0.3,
                                      torch.device("cpu")), want)
    assert want.shape == (30, 3)


PAIRED_CASES = [(37, 8, None), (37, 100, 0.5), (11, 1, 1.0), (1, 20, None),
                (29, 16, 1e-30)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lib_size,d,density", PAIRED_CASES)
def test_paired_table_plain_is_the_table(lib_size, d, density, dtype):
    """paired_table_plain (K8's reference) equals JAX's dense paired table
    in bit patterns, +0.0 where the stream draws no entry included, at
    chunks of 16 and 1 << 16 rows: d = 100 and d = 1 leave a ragged
    vector, density 1.0 fills every field, 1e-30 none (a negative bound),
    L = 1 is one row and the zero row. No count equals 2L, whose ICF XLA
    and torch round apart (test_sign_table_bitwise). At L <= 3 XLA's CPU
    backend leaves JAX's nonzero * sign product unrewritten and gives
    -0.0 where a field with a minus sign draws no entry (from L = 4 on it
    gives +0.0, as the port does at every L): there the values are
    compared, not the bits. On the CPU build_precompute_paired is
    paired_table_plain."""
    counts = np.random.default_rng(lib_size + d).integers(
        2, 50, lib_size).astype(np.int32)
    counts[counts == 2 * lib_size] += 1
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    t_counts = torch.from_numpy(counts.astype(np.int64))
    for chunk in (CHUNK, 1 << 16):
        want = paired_table_to_port(jsrp.build_precompute_paired(
            jnp.asarray(counts), d, 2094, density, chunk=chunk,
            dtype=getattr(jnp, dtype)))
        icf, dens, mix, scale = srp._stream(t_counts, d, 2094, density)
        got = srp.paired_table_plain(icf, d, mix, dens, scale,
                                     getattr(torch, dtype), chunk)
        assert got.shape == (lib_size + 1, 2 * d)
        assert torch.equal(got.float(), want.float())
        if lib_size >= 4:
            assert torch.equal(got.view(view), want.view(view))
        assert not torch.signbit(got[got == 0]).any()
        assert torch.equal(srp.build_precompute_paired(
            t_counts, d, 2094, density, chunk=chunk,
            dtype=getattr(torch, dtype)).view(view), got.view(view))
    if density == 1e-30:
        assert not got.view(view).any()
    assert not got[lib_size].view(view).any()
