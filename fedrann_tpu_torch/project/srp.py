"""ICF weights and the sparse random projection (the port of
`fedrann_tpu/project/srp.py` `build_precompute_signs`,
`build_precompute_paired` and `pair_projection`).

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

On a CUDA device the sign table is the hand kernel K5 (csrc/srp_signs.cu,
one thread a packed word); on the CPU its plain version, sign_table_plain,
draws the codes chunk by chunk in int64 torch ops and packs them.

`--projection-dtype f32|bf16` stores the same table dense: paired row j is
[P[j] | P[j+L]] in float32, or rounded to bfloat16 (nearest even), with an
all-zero sentinel row L. Its f32 entries equal the sign table's sign *
mags[j] bitwise. On a CUDA device it is the hand kernel K8
(csrc/srp_signs.cu `fk_srp_paired`, one thread a 16-byte vector of a half
row); on the CPU its plain version, paired_table_plain, builds it chunk by
chunk in int64 torch ops.
"""

from __future__ import annotations

import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.kmers.codec import _GOLDEN, splitmix64


def icf_weights(counts: torch.Tensor) -> torch.Tensor:
    """(L,) canonical multiplicities -> (2L,) float32 ICF weights (computed
    in float64, then rounded)."""
    n_features = 2 * counts.shape[0]
    c = torch.cat([counts, counts]).to(torch.float64)
    return torch.log(n_features / (c + 1e-12)).to(torch.float32)


def _sign_bound(density: float) -> int:
    """The nonzero test's bound: a field is nonzero iff (h >>> 1) <= it,
    the JAX package's (h >>> 1) < density * 2^63 written with <= so that
    it fits int64 at density 1 (negative: no field is nonzero)."""
    return int(density * 2.0**63) - 1


def _srp_bits(seed_mix: torch.Tensor, n_components: int, density: float,
              chunk_start: int, chunk_size: int, device: torch.device):
    """(nonzero, positive) (chunk, d) bools on `device` of features
    [chunk_start, +chunk_size): the splitmix64 stream of feature and
    component."""
    f = (torch.arange(chunk_size, dtype=torch.int64, device=device)
         + chunk_start)[:, None] * _GOLDEN
    c = torch.arange(n_components, dtype=torch.int64, device=device)[None, :]
    h = splitmix64(f + c + seed_mix)
    return (((h >> 1) & ((1 << 63) - 1)) <= _sign_bound(density),
            (h & 1) == 1)


def _srp_sign_chunk(seed_mix: torch.Tensor, n_components: int,
                    density: float, chunk_start: int, chunk_size: int,
                    device: torch.device) -> torch.Tensor:
    """(chunk, d) int32 sign codes of features [chunk_start, +chunk_size)."""
    nonzero, pos = _srp_bits(seed_mix, n_components, density, chunk_start,
                             chunk_size, device)
    return torch.where(nonzero, torch.where(pos, 1, 2), 0).to(torch.int32)


def _srp_chunk(seed_mix: torch.Tensor, icf_chunk: torch.Tensor,
               n_components: int, density: float, chunk_start: int,
               scale: torch.Tensor) -> torch.Tensor:
    """(chunk, d) float32 entries sign * scale * icf of features
    [chunk_start, +len(icf_chunk)), in the JAX package's order of float32
    products, and +0.0 where the stream draws no entry (as XLA selects)."""
    nonzero, pos = _srp_bits(seed_mix, n_components, density, chunk_start,
                             icf_chunk.shape[0], icf_chunk.device)
    sign = torch.where(pos, 1.0, -1.0).to(torch.float32)
    return torch.where(nonzero, sign * scale * icf_chunk[:, None], 0.0)


def _pack_signs(codes: torch.Tensor) -> torch.Tensor:
    """(rows, w) 2-bit codes -> (rows, ceil(w/16)) int32 bit patterns."""
    r, w = codes.shape
    codes = torch.nn.functional.pad(codes.to(torch.int64), (0, (-w) % 16))
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=codes.device)
    words = (codes.reshape(r, -1, 16) << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def seed_mix_of(seed: int) -> torch.Tensor:
    """splitmix64(seed), the stream's key, as a 0-d int64 CPU tensor (a
    scalar to ops on any device)."""
    return splitmix64(torch.tensor(seed, dtype=torch.int64))


def _stream(counts: torch.Tensor, n_components: int, seed: int,
            density: float | None):
    """(icf, density, seed_mix, scale) of a projection over counts."""
    icf = icf_weights(counts)
    if density is None:
        density = 1.0 / float(icf.shape[0]) ** 0.5 if icf.shape[0] else 1.0
    scale = torch.tensor((1.0 / density) ** 0.5 / n_components**0.5,
                         dtype=torch.float32, device=counts.device)
    return icf, density, seed_mix_of(seed), scale


def sign_table_plain(lib_size: int, n_components: int,
                     seed_mix: torch.Tensor, density: float,
                     device: torch.device,
                     chunk: int = 1 << 16) -> torch.Tensor:
    """The (L+1, ceil(2d/16)) int32 sign table in plain PyTorch on
    `device`: chunk by chunk, the codes of both halves (_srp_sign_chunk)
    packed (_pack_signs), then the zero row L. The CPU path, and the
    reference the tests and chip_smoke.py hold K5 to."""
    parts = []
    for start in range(0, lib_size, chunk):
        size = min(chunk, lib_size - start)
        left = _srp_sign_chunk(seed_mix, n_components, density, start, size,
                               device)
        right = _srp_sign_chunk(seed_mix, n_components, density,
                                lib_size + start, size, device)
        parts.append(_pack_signs(torch.cat([left, right], dim=1)))
    parts.append(torch.zeros((1, (2 * n_components + 15) // 16),
                             dtype=torch.int32, device=device))
    return torch.cat(parts)


def sign_table(lib_size: int, n_components: int, seed_mix: torch.Tensor,
               density: float, device: torch.device,
               chunk: int = 1 << 16) -> torch.Tensor:
    """sign_table_plain's table on `device`: on the CPU the plain version;
    on a CUDA device one launch of K5 (csrc/srp_signs.cu `fk_srp_signs`),
    counted in .kernel_launches."""
    if device.type == "cpu":
        return sign_table_plain(lib_size, n_components, seed_mix, density,
                                device, chunk)
    if device.type != "cuda":
        raise ValueError(f"sign_table: unsupported device {device}")
    n_words = (2 * n_components + 15) // 16
    out = torch.empty((lib_size + 1, n_words), dtype=torch.int32,
                      device=device)
    _build.launch("fk_srp_signs", int(seed_mix) & ((1 << 64) - 1), lib_size,
                  n_components, n_words, _sign_bound(density),
                  out.data_ptr(), device=device)
    sign_table.kernel_launches += 1
    return out


sign_table.kernel_launches = 0


def build_precompute_signs(counts: torch.Tensor, n_components: int,
                           seed: int, density: float | None = None,
                           chunk: int = 1 << 16):
    """(signs (L+1, ceil(2d/16)) int32, mags (L+1,) float32) on counts'
    device; row j packs [P[j] | P[j+L]] and reconstructs the f32 entries
    exactly as sign * mags[j]. The signs are sign_table's (K5 on a card);
    the magnitudes are torch ops."""
    device = counts.device
    lib_size = int(counts.shape[0])
    icf, density, seed_mix, scale = _stream(counts, n_components, seed,
                                            density)
    signs = sign_table(lib_size, n_components, seed_mix, density, device,
                       chunk)
    mags = torch.cat([icf[:lib_size] * scale,
                      torch.zeros(1, dtype=torch.float32, device=device)])
    return signs, mags


def paired_table_plain(icf: torch.Tensor, n_components: int,
                       seed_mix: torch.Tensor, density: float,
                       scale: torch.Tensor, dtype: torch.dtype,
                       chunk: int = 1 << 16) -> torch.Tensor:
    """The (L+1, 2d) dense paired table in plain PyTorch on icf's device
    (icf the (2L,) ICF weights): chunk by chunk, both halves' float32
    entries (_srp_chunk) cast to dtype, so no whole float32 table exists
    beside a bfloat16 one, then the zero row L. The CPU path, and the
    reference the tests and chip_smoke.py hold K8 to."""
    lib_size = icf.shape[0] // 2
    parts = []
    for start in range(0, lib_size, chunk):
        size = min(chunk, lib_size - start)
        # the right half draws the flat features [L + start, +size)
        parts.append(torch.cat([
            _srp_chunk(seed_mix, icf[start : start + size], n_components,
                       density, start, scale).to(dtype),
            _srp_chunk(seed_mix, icf[lib_size + start : lib_size + start
                                     + size], n_components, density,
                       lib_size + start, scale).to(dtype)], dim=1))
    parts.append(torch.zeros((1, 2 * n_components), dtype=dtype,
                             device=icf.device))
    return torch.cat(parts)


def paired_table(icf: torch.Tensor, n_components: int,
                 seed_mix: torch.Tensor, density: float,
                 scale: torch.Tensor, dtype: torch.dtype,
                 chunk: int = 1 << 16) -> torch.Tensor:
    """paired_table_plain's table on icf's device: on the CPU the plain
    version; on a CUDA device one launch of K8 (csrc/srp_signs.cu
    `fk_srp_paired`) from the magnitudes icf[:L] * scale, counted in
    .kernel_launches."""
    device = icf.device
    if device.type == "cpu":
        return paired_table_plain(icf, n_components, seed_mix, density,
                                  scale, dtype, chunk)
    if device.type != "cuda":
        raise ValueError(f"paired_table: unsupported device {device}")
    lib_size = icf.shape[0] // 2
    mags = (icf[:lib_size] * scale).contiguous()
    out = torch.empty((lib_size + 1, 2 * n_components), dtype=dtype,
                      device=device)
    _build.launch("fk_srp_paired", int(seed_mix) & ((1 << 64) - 1),
                  lib_size, n_components, _sign_bound(density),
                  mags.data_ptr(), int(dtype == torch.bfloat16),
                  out.data_ptr(), device=device)
    paired_table.kernel_launches += 1
    return out


paired_table.kernel_launches = 0


def build_precompute_paired(counts: torch.Tensor, n_components: int,
                            seed: int, density: float | None = None,
                            chunk: int = 1 << 16,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """(L+1, 2d) dense paired table on counts' device: row j = [P[j] |
    P[j+L]], row L all zero, in float32 or bfloat16 (round to nearest
    even). The table is paired_table's (K8 on a card); the ICF weights
    are torch ops."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, not {dtype}")
    icf, density, seed_mix, scale = _stream(counts, n_components, seed,
                                            density)
    return paired_table(icf, n_components, seed_mix, density, scale, dtype,
                        chunk)


def pair_projection(p_ext: torch.Tensor) -> torch.Tensor:
    """Flat (2L+1, d) table (an imported projection) -> the paired (L+1,
    2d) layout: row j = [p_ext[j] | p_ext[j+L]], then a zero row."""
    n_rows, d = p_ext.shape
    lib_size = (n_rows - 1) // 2
    return torch.cat([
        torch.cat([p_ext[:lib_size], p_ext[lib_size : 2 * lib_size]], dim=1),
        p_ext.new_zeros((1, 2 * d))])
