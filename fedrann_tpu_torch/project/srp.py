"""ICF weights and the sign-packed sparse random projection (the port of
`fedrann_tpu/project/srp.py` `build_precompute_signs`).

P[f, c] = ICF[f] * SRP[f, c]; SRP entries are nonzero with probability
density (default 1/sqrt(n_features)) and worth +-sqrt(1/density)/sqrt(d);
ICF = log(n_features / (count + 1e-12)), shared by the fwd (f < L) and
rev (f >= L) halves. The stream is counter-based (splitmix64 of feature
and component), so the table is bitwise the JAX package's.

The table factorizes: every nonzero of paired row j = [P[j] | P[j+L]] is
+-(scale * icf[j]). It is stored as 2-bit sign codes (0 zero, 1 plus,
2 minus), 16 per 32-bit word (field i at bits 2*(i%16) of word i//16),
held as int32 bit patterns, plus one float32 magnitude per row; row L is
the all-zero sentinel row with magnitude 0.
"""

from __future__ import annotations

import torch

from fedrann_tpu_torch.kmers.codec import _GOLDEN, splitmix64


def icf_weights(counts: torch.Tensor) -> torch.Tensor:
    """(L,) canonical multiplicities -> (2L,) float32 ICF weights (computed
    in float64, then rounded)."""
    n_features = 2 * counts.shape[0]
    c = torch.cat([counts, counts]).to(torch.float64)
    return torch.log(n_features / (c + 1e-12)).to(torch.float32)


def _srp_sign_chunk(seed_mix: torch.Tensor, n_components: int,
                    density: float, chunk_start: int,
                    chunk_size: int) -> torch.Tensor:
    """(chunk, d) int32 sign codes of features [chunk_start, +chunk_size)."""
    device = seed_mix.device
    f = (torch.arange(chunk_size, dtype=torch.int64, device=device)
         + chunk_start)[:, None] * _GOLDEN
    c = torch.arange(n_components, dtype=torch.int64, device=device)[None, :]
    h = splitmix64(f + c + seed_mix)
    # nonzero iff (h >>> 1) < density * 2^63, written with <= so the bound
    # fits int64 at density 1
    bound = int(density * 2.0**63) - 1
    nonzero = ((h >> 1) & ((1 << 63) - 1)) <= bound
    pos = (h & 1) == 1
    return torch.where(nonzero, torch.where(pos, 1, 2), 0).to(torch.int32)


def _pack_signs(codes: torch.Tensor) -> torch.Tensor:
    """(rows, w) 2-bit codes -> (rows, ceil(w/16)) int32 bit patterns."""
    r, w = codes.shape
    codes = torch.nn.functional.pad(codes.to(torch.int64), (0, (-w) % 16))
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=codes.device)
    words = (codes.reshape(r, -1, 16) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def build_precompute_signs(counts: torch.Tensor, n_components: int,
                           seed: int, density: float | None = None,
                           chunk: int = 1 << 16):
    """(signs (L+1, ceil(2d/16)) int32, mags (L+1,) float32) on counts'
    device; row j packs [P[j] | P[j+L]] and reconstructs the f32 entries
    exactly as sign * mags[j]."""
    device = counts.device
    icf = icf_weights(counts)
    n_features = icf.shape[0]
    lib_size = int(counts.shape[0])
    if density is None:
        density = 1.0 / float(n_features) ** 0.5 if n_features else 1.0
    seed_mix = splitmix64(torch.tensor(seed, dtype=torch.int64,
                                       device=device))
    scale = torch.tensor((1.0 / density) ** 0.5 / n_components**0.5,
                         dtype=torch.float32, device=device)
    parts = []
    for start in range(0, lib_size, chunk):
        size = min(chunk, lib_size - start)
        left = _srp_sign_chunk(seed_mix, n_components, density, start, size)
        right = _srp_sign_chunk(seed_mix, n_components, density,
                                lib_size + start, size)
        parts.append(_pack_signs(torch.cat([left, right], dim=1)))
    parts.append(torch.zeros((1, (2 * n_components + 15) // 16),
                             dtype=torch.int32, device=device))
    signs = torch.cat(parts)
    mags = torch.cat([icf[:lib_size] * scale,
                      torch.zeros(1, dtype=torch.float32, device=device)])
    return signs, mags
