"""The sign table of fedrann_tpu_torch's projection (the plain version of
K5, csrc/srp_signs.cu) against the JAX `build_precompute_signs`, bitwise,
across densities, library sizes and widths."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu.project import srp as jsrp
from fedrann_tpu_torch.convert import signs_to_port
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
