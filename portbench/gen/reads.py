"""Read sets made on the device from a seed, with no reads, FASTA or file:
the (2R, d) float32 embedding rows that fedrann_tpu_torch's embed stage
would give for R long reads of a genome, made from the pipeline's own
arithmetic.

The model (every parameter from the configuration's own sizes):

- A genome of G bases holds S = round((G - k + 1) * f) sampled k-mer sites
  at uniform positions, f the --kmer-sample-fraction (the library's hash
  keeps a canonical k-mer with probability f).
- R = round(coverage * G / mean) reads; a read's length is N(mean, 20%)
  clipped to [mean // 4, G] and truncated, its start uniform in [0, G -
  length), its strand + or - with equal odds (fedrann_tpu_torch/sim.py's
  draws). A read holds the sites whose k bases lie inside it.
- A read keeps each of its sites with probability (1 - e)^k, the chance
  that the k-mer escapes sequencing errors (e the error rate). A site kept
  by fewer than --kmer-min-multiplicity reads leaves the library; the L
  sites left are the library, ranked by position.
- Each library site has two features, one per strand: feature s where the
  read-strand k-mer is the canonical one (a + read), s + L where it is
  its reverse complement (a - read); a read's reverse-complement row
  mirrors them (s <-> s + L). Each feature's SRP row is sparse: each of
  its d entries is nonzero with probability density = 1 / sqrt(2 L)
  (--projection-density where given), +-sqrt(1 / density) / sqrt(d), and
  the row is weighted by ICF = log(2 L / (count + 1e-12)), count the
  site's kept occurrences in all reads (the formulas of the port's
  oracle.srp_matrix and icf_weights, copied).
- A read's rows are the sums of its kept library features' weighted SRP
  rows: row 2 r its own strand's, row 2 r + 1 the mirror's.

The SRP rows are drawn as their nonzero entries (density * 2 L * d of
them at uniform (feature, component), a repeated pair kept once), not
from the port's splitmix64 stream: the same distribution, another stream.
Every step is deterministic on the device (sorts, scans, integer
bincounts; each row's sum in float64 in a fixed order), so a seed gives
the same rows bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch


# a read length's standard deviation as a share of the mean (assumed, as
# fedrann_tpu_torch/sim.py draws them)
READ_LENGTH_SD = 0.2


@dataclasses.dataclass(frozen=True)
class Dataset:
    """The configuration's dataset: genome bases, coverage, mean read
    length and the per-base error rate."""

    genome_bases: int
    coverage: float
    mean_read_length: int
    error_rate: float

    @property
    def n_reads(self) -> int:
        return max(2, int(round(self.coverage * self.genome_bases
                                / self.mean_read_length)))


@dataclasses.dataclass(frozen=True)
class Features:
    """The feature and projection settings the rows are made with: k, the
    sample fraction, the minimum multiplicity, the width d and the SRP
    density (None: 1 / sqrt(n_features))."""

    k: int
    sample_fraction: float
    min_multiplicity: int
    d: int
    density: float | None = None


@dataclasses.dataclass
class Layout:
    """Each read's genome interval [start, end) and strand (0 = +)."""

    starts: torch.Tensor   # (R,) int64
    ends: torch.Tensor     # (R,) int64
    strands: torch.Tensor  # (R,) int64


@dataclasses.dataclass
class ReadSet:
    rows: torch.Tensor     # (2R, d) float32, read r's rows 2r and 2r + 1
    layout: Layout
    library_size: int


def draw_layout(ds: Dataset, gen: torch.Generator,
                device: torch.device) -> Layout:
    """R reads of N(mean, sd * mean) bases clipped to [mean // 4, G] and
    truncated, at uniform starts in [0, G - length), on a random strand."""
    r, m = ds.n_reads, ds.mean_read_length
    lengths = (torch.randn(r, generator=gen, device=device,
                           dtype=torch.float64) * (m * READ_LENGTH_SD)
               + m).clamp(m // 4, ds.genome_bases).long()
    span = (ds.genome_bases - lengths).clamp_min(1)
    starts = (torch.rand(r, generator=gen, device=device,
                         dtype=torch.float64) * span).long()
    strands = torch.randint(0, 2, (r,), generator=gen, device=device)
    return Layout(starts, starts + lengths, strands)


def _expand(counts: torch.Tensor):
    """(owner, rank) of each item of runs of `counts` items: owner the
    run's index, rank the item's place in its run."""
    owner = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(owner.shape[0], device=counts.device) - first[owner]
    return owner, rank


def _srp_entries(n_features: int, d: int, density: float,
                 gen: torch.Generator, device: torch.device):
    """The nonzero entries of a sparse (n_features, d) SRP matrix, sorted
    by (feature, component): (ptr (n_features + 1,) int64, component
    int64, value float32 +-sqrt(1 / density) / sqrt(d))."""
    nnz = int(round(n_features * d * density))
    key = (torch.randint(0, n_features, (nnz,), generator=gen,
                         device=device) * d
           + torch.randint(0, d, (nnz,), generator=gen, device=device))
    sign = torch.randint(0, 2, (nnz,), generator=gen, device=device) * 2 - 1
    key, order = torch.sort(key, stable=True)
    sign = sign[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]  # a pair drawn twice is kept once
    key, sign = key[first], sign[first]
    scale = math.sqrt(1.0 / density) / math.sqrt(d)
    value = (sign.to(torch.float64) * scale).to(torch.float32)
    ptr = torch.searchsorted(
        key // d, torch.arange(n_features + 1, device=device))
    return ptr, key % d, value


def _segment_sums(keys: torch.Tensor, values: torch.Tensor):
    """(distinct keys ascending, the float64 sum of each key's values in
    its order of appearance): a stable sort and a scan, no atomics."""
    keys, order = torch.sort(keys, stable=True)
    values = values[order].to(torch.float64)
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    scan = torch.cumsum(values, 0)
    before = torch.cat([scan.new_zeros(1), scan[ends[:-1]]])
    return uniq, scan[ends] - before


def make_rows(layout: Layout, ds: Dataset, ft: Features,
              gen: torch.Generator) -> ReadSet:
    """The read set of `layout` on its device: sites, kept occurrences,
    library, ICF-weighted sparse SRP rows, as the module docstring sets
    out."""
    device = layout.starts.device
    g, k = ds.genome_bases, ft.k
    n_sites = int(round((g - k + 1) * ft.sample_fraction))
    pos = torch.sort(torch.randint(0, g - k + 1, (n_sites,), generator=gen,
                                   device=device)).values
    lo = torch.searchsorted(pos, layout.starts)
    hi = torch.searchsorted(pos, layout.ends - k, right=True)
    read, rank = _expand((hi - lo).clamp_min(0))
    site = lo[read] + rank
    del rank
    kept = torch.rand(site.shape[0], generator=gen, device=device,
                      dtype=torch.float64) < (1.0 - ds.error_rate) ** k
    read, site = read[kept], site[kept]
    del kept
    count = torch.bincount(site, minlength=n_sites)
    in_lib = count >= ft.min_multiplicity
    lib_size = int(in_lib.sum())
    n_features = 2 * lib_size
    lib_rank = torch.cumsum(in_lib, 0) - 1
    icf = torch.log(n_features / (count.to(torch.float64) + 1e-12)
                    ).to(torch.float32)
    sel = in_lib[site]
    read, site = read[sel], site[sel]
    del sel
    weight = icf[site]
    feat = lib_rank[site]
    del site, lib_rank, icf, count, in_lib
    density = ft.density or 1.0 / math.sqrt(max(n_features, 1))
    ptr, comp, value = _srp_entries(max(n_features, 1), ft.d, density, gen,
                                    device)
    rows = torch.zeros((2 * layout.starts.shape[0]) * ft.d,
                       dtype=torch.float32, device=device)
    strand = layout.strands[read]
    for side in (0, 1):  # the read's own strand, then its mirror
        f = feat + lib_size * (strand ^ side)
        owner, rank = _expand(ptr[f + 1] - ptr[f])
        entry = ptr[f[owner]] + rank
        del rank
        out_key = (2 * read[owner] + side) * ft.d + comp[entry]
        uniq, sums = _segment_sums(out_key, weight[owner] * value[entry])
        del owner, entry, out_key
        rows[uniq] = sums.to(torch.float32)
        del uniq, sums
    return ReadSet(rows.view(-1, ft.d), layout, lib_size)


def make_read_set(ds: Dataset, ft: Features, seed: int,
                  device: torch.device) -> ReadSet:
    """The read set of `seed`: its layout, then its rows, from one
    generator on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return make_rows(draw_layout(ds, gen, device), ds, ft, gen)


def truth_pairs(layout: Layout, min_overlap: int) -> torch.Tensor:
    """(P, 2) int64 read pairs (a < b) whose genome intervals overlap by at
    least min_overlap bases (fedrann_tpu_torch/sim.py's truth_overlaps),
    on the layout's device."""
    order = torch.argsort(layout.starts, stable=True)
    s, e = layout.starts[order], layout.ends[order]
    n = s.shape[0]
    # a read's partners start at or after it and at most at its end less
    # min_overlap: sorted positions i + 1 .. hi - 1
    hi = torch.searchsorted(s, e - min_overlap, right=True)
    i, rank = _expand((hi - torch.arange(n, device=s.device) - 1)
                      .clamp_min(0))
    j = i + 1 + rank
    del rank
    overlap = torch.minimum(e[i], e[j]) - s[j]
    ok = overlap >= min_overlap
    a, b = order[i[ok]], order[j[ok]]
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b)], 1)
