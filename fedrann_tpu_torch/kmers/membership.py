"""Per-read candidate staging (kernel B, `select_candidates`) and library
membership.

Staging widths and caps are those of `fedrann_tpu/kmers/membership.py`:
rows longer than 2 * SELECT_BLOCK windows select per 1024-slot block (each
block keeps its first `selection_cap(fraction)` sorted slots), then the
survivors are sorted and the first `width` kept, with an exact count of the
candidate occurrences that did not fit. Duplicates are kept (the library
counts occurrences); membership drops a slot equal to its left neighbour.

Kernel B takes one of two paths per row shape, chosen by
`stage_launch_plan`: a row whose survivors fit a thread block's shared
memory is staged by one block (each 1024-slot block's candidates
compacted, sorted only past the cap, then one sort of the survivors); a
longer row (keep_all past 28,928 windows, or blocked rows at high
sampling: >= 6.5% at the 262,144-base bucket, >= 14.5% at 131,072) is
sorted in shared-memory chunks that are merged in device memory.
`stage_candidates` stages bases, a byte matrix or the packer's 2-bit form
(a `codec.PackedChunk`, as the pipeline uploads it): on the one-block path
kernels A and B run fused (`fk_stage_rows`: the block computes its slots
from the bases, so the (R, W) slot plane never reaches device memory); on
the device-memory path kernel A writes the plane and `select_candidates`
reads it. The one-block path takes bases only, so `select_candidates`
refuses CUDA slots whose rows it would keep in one block.

Membership here (`read_hits_staged`, the plain version of kernel C's
lookups) is `torch.searchsorted` on the sorted int64 library; kernel C
looks codes up through a prefix table of the library, which its L2
traffic on the H100 asked for (PERF.md section 6).
"""

from __future__ import annotations

import dataclasses

import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.device import SM90_SMEM_OPTIN, shared_memory_limit
from fedrann_tpu_torch.kmers.codec import (
    PAD_SLOT,
    SOURCES,
    _canonical_sample_plain,
    as_bytes,
    canonical_sample,
    check_bases,
    count_launch,
    reset_counts,
    seed_mix32,
    source_args,
)

SELECT_BLOCK = 1024
# shared memory kept free for the one-block kernel's static arrays (bytes):
# its scan scratch and, fused, one block of packed bases (672 B as built
# for sm_90a; chip_smoke.py checks the built kernels against it)
STATIC_SMEM = 1024
# slots per shared-memory chunk sort of the long-row path (128 KB)
LONG_CHUNK = 16384


def selection_cap(fraction: float, block: int = SELECT_BLOCK) -> int:
    """Per-block survivor cap: sampling mean + 6 sigma over one block."""
    mean = fraction * block
    return max(8, int(mean + 6.0 * mean ** 0.5) + 1)


def staging_width(w: int, fraction: float) -> int:
    """Per-read candidate-buffer width: sampling mean + 6 sigma, rounded up
    to a multiple of 128, at least 512, at most the window count."""
    mean = fraction * w
    width = int(mean + 6.0 * mean ** 0.5) + 1
    return min(w, max(512, -(-width // 128) * 128))


def _pow2(n: int) -> int:
    return 1 << max(0, (max(int(n), 1) - 1).bit_length())


def _selection_plan(w: int, hit_buffer: int, keep_all: bool,
                    block_cap: int | None):
    """(blocked, cap, n_blocks, width) for a row of w slots."""
    if keep_all or block_cap is None or w <= 2 * SELECT_BLOCK:
        return False, 0, 0, hit_buffer
    g = -(-w // SELECT_BLOCK)
    c = min(int(block_cap), SELECT_BLOCK)
    return True, c, g, min(hit_buffer, g * c)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How kernel B stages rows of w slots: one block per row (smem > 0)
    or the device-memory path (chunk > 0)."""

    blocked: bool    # per-1024-slot-block selection before the row sort
    cap: int         # slots each block keeps (blocked)
    n_blocks: int    # 1024-slot blocks per row (blocked)
    width: int       # staged slots per row
    n_surv: int      # most survivors per row: n_blocks * cap (blocked), or w
    smem: int = 0    # one block per row: bytes of its shared memory
    chunk: int = 0   # device-memory path: slots per shared-memory chunk
    n_chunks: int = 0  # device-memory path: chunks per row, a power of 2

    @property
    def long(self) -> bool:
        return self.chunk > 0

    @property
    def passes(self) -> tuple:
        """((kernel, shared-memory bytes), ...) in launch order."""
        if not self.long:
            return (("select_stage_rows", self.smem),)
        return ((("select_blocks", 8 * SELECT_BLOCK),) if self.blocked
                else ()) + (("sort_chunks", 8 * self.chunk),) + (
            ("merge_runs", 0),) * (self.n_chunks.bit_length() - 1) + (
            ("stage_dropped", 0),)


def stage_launch_plan(w: int, hit_buffer: int, keep_all: bool,
                      block_cap: int | None,
                      smem_limit: int = SM90_SMEM_OPTIN) -> StagePlan:
    """The passes kernel B runs for a row of w slots and the shared memory
    of each. Rows whose survivor buffer fits smem_limit (less STATIC_SMEM)
    take the one-block-per-row kernel: the buffer holds every survivor but
    the last block's plus that block's candidates, (n_blocks - 1) * cap +
    SELECT_BLOCK slots (blocked), or the row's w (full width). Longer rows
    take the device-memory path: blocked selection (when blocked), chunk
    sorts of LONG_CHUNK slots (fewer if the limit is lower), log2(n_chunks)
    pairwise merges and the dropped count."""
    blocked, c, g, width = _selection_plan(w, hit_buffer, keep_all,
                                           block_cap)
    n_surv = g * c if blocked else w
    smem = 8 * (min(w, (g - 1) * c + SELECT_BLOCK) if blocked else w)
    if smem + STATIC_SMEM <= smem_limit:
        return StagePlan(blocked, c, g, width, n_surv, smem=smem)
    chunk = min(LONG_CHUNK, 1 << ((smem_limit // 8).bit_length() - 1))
    if chunk < SELECT_BLOCK:
        raise ValueError(f"{smem_limit} bytes of shared memory cannot hold "
                         f"a {SELECT_BLOCK}-slot sort block")
    return StagePlan(blocked, c, g, width, n_surv, chunk=chunk,
                     n_chunks=_pow2(-(-n_surv // chunk)))


def _select_candidates_plain(slots, hit_buffer, keep_all, block_cap):
    r, w = slots.shape
    n_cand = (slots != PAD_SLOT).sum(dim=1)
    blocked, c, g, width = _selection_plan(w, hit_buffer, keep_all,
                                           block_cap)
    if not blocked:
        staged = torch.sort(slots, dim=1).values[:, :hit_buffer]
        return staged, (n_cand - hit_buffer).clamp(min=0).to(torch.int32)
    # (F.pad takes a float fill value, which cannot hold PAD_SLOT exactly)
    padded = torch.cat([slots, slots.new_full((r, g * SELECT_BLOCK - w),
                                              PAD_SLOT)], dim=1)
    blocks = torch.sort(padded.reshape(r * g, SELECT_BLOCK), dim=1).values
    narrow = blocks[:, :c].reshape(r, g * c)
    staged = torch.sort(narrow, dim=1).values[:, :width]
    cnt_blocks = (padded != PAD_SLOT).reshape(r, g, SELECT_BLOCK).sum(dim=2)
    survivors = cnt_blocks.clamp(max=c).sum(dim=1)
    return staged, (n_cand - survivors.clamp(max=width)).to(torch.int32)


def select_candidates(slots: torch.Tensor, hit_buffer: int, keep_all: bool,
                      block_cap: int | None = None):
    """(R, W) int64 slots (canonical_sample output) -> (staged (R, width)
    int64 sorted ascending with PAD_SLOT last, dropped (R,) int32).

    width is hit_buffer (full-width selection) or min(hit_buffer,
    n_blocks * cap) (blocked selection, W > 2 * SELECT_BLOCK with a
    block_cap and not keep_all). A CPU tensor takes the plain PyTorch
    version. A CUDA tensor launches kernel B's device-memory path
    (csrc/select_stage_rows.cu), counted in `.long_launches`, for rows
    that `stage_launch_plan` cannot keep in one block's shared memory;
    rows it can keep there stage from their bases, fused with kernel A
    (`stage_candidates`), and raise ValueError here."""
    if slots.dtype != torch.int64 or slots.dim() != 2:
        raise ValueError("slots must be a 2-D int64 tensor")
    r, w = slots.shape
    if not 1 <= hit_buffer <= w:
        raise ValueError(f"hit_buffer {hit_buffer} must be in [1, {w}]")
    if slots.device.type == "cpu":
        return _select_candidates_plain(slots, hit_buffer, keep_all,
                                        block_cap)
    if slots.device.type != "cuda":
        raise ValueError(f"unsupported device {slots.device}")
    return _select_on_card(slots, hit_buffer, stage_launch_plan(
        w, hit_buffer, keep_all, block_cap, shared_memory_limit(slots.device)))


def _select_on_card(slots: torch.Tensor, hit_buffer: int, plan: StagePlan):
    """Kernel B's device-memory path on a CUDA tensor along `plan` (the
    path select_candidates picks, or one forced to time it against the
    fused kernel); a one-block plan raises ValueError."""
    if not plan.long:
        raise ValueError(
            "rows that fit one block's shared memory stage from their bases "
            "with kernels A and B fused: call stage_candidates")
    r, w = slots.shape
    slots = slots.contiguous()
    dev = slots.device
    staged = torch.empty((r, plan.width), dtype=torch.int64, device=dev)
    dropped = torch.empty((r,), dtype=torch.int32, device=dev)
    n_pad = plan.chunk * plan.n_chunks
    groups = plan.n_blocks if plan.blocked else plan.n_chunks

    def scratch(shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device=dev)

    surv = scratch((r, plan.n_surv) if plan.blocked else (0,))
    buf_a = scratch((r, n_pad) if plan.n_chunks >= 2 else (0,))
    buf_b = scratch((r, n_pad) if plan.n_chunks >= 4 else (0,))
    cand = scratch((r, groups), torch.int32)
    kept = scratch((r, groups), torch.int32) if plan.blocked else cand
    _build.launch("fk_select_stage_long", slots.data_ptr(), r, w,
                  int(plan.blocked), plan.cap, plan.n_blocks, plan.n_surv,
                  plan.chunk, plan.n_chunks, plan.width, surv.data_ptr(),
                  buf_a.data_ptr(), buf_b.data_ptr(), cand.data_ptr(),
                  kept.data_ptr(), staged.data_ptr(), dropped.data_ptr(),
                  device=dev)
    select_candidates.long_launches += 1
    return staged, dropped


select_candidates.long_launches = 0  # the device-memory path


def stage_candidates(bases, k: int, hit_buffer: int, keep_all: bool,
                     seed: int, threshold: int, block_cap: int | None = None):
    """Canonical windows + sampling filter + candidate selection: the
    staging stage that both the count and the embed stages consume. (R, L)
    bases, a uint8 byte matrix or a PackedChunk (codec.py) -> select_candidates'
    (staged, dropped) of their canonical_sample slots.

    A CPU input takes the plain versions (a PackedChunk unpacked first). On
    a CUDA one, rows that `stage_launch_plan` keeps in one block launch
    kernels A and B fused (csrc/select_stage_rows.cu `fk_stage_rows`) on
    the input's source, counted in `.launches` and `.<source>_launches`;
    longer rows launch kernel A, then kernel B's device-memory path."""
    w = check_bases(bases, k)
    if not 1 <= hit_buffer <= w:
        raise ValueError(f"hit_buffer {hit_buffer} must be in [1, {w}]")
    if bases.device.type == "cpu":
        return _select_candidates_plain(
            _canonical_sample_plain(as_bytes(bases), k, seed, threshold,
                                    keep_all),
            hit_buffer, keep_all, block_cap)
    plan = stage_launch_plan(w, hit_buffer, keep_all, block_cap,
                             shared_memory_limit(bases.device))
    if plan.long:
        slots = canonical_sample(bases, k, seed, threshold, keep_all)
        return _select_on_card(slots, hit_buffer, plan)
    return _stage_on_card(bases, k, hit_buffer, keep_all, seed, threshold,
                          plan)


def _stage_on_card(bases, k, hit_buffer, keep_all, seed, threshold,
                   plan: StagePlan):
    """Kernels A and B fused on a CUDA input, on the one-block `plan`."""
    r, length = bases.shape
    data, aux, source = source_args(bases)
    dev = bases.device
    staged = torch.empty((r, plan.width), dtype=torch.int64, device=dev)
    dropped = torch.empty((r,), dtype=torch.int32, device=dev)
    s1, s2 = seed_mix32(seed)
    _build.launch("fk_stage_rows", data.data_ptr(),
                  None if aux is None else aux.data_ptr(), SOURCES[source],
                  r, length, length - k + 1, k, s1, s2,
                  int(threshold) & 0xFFFFFFFF, int(bool(keep_all)),
                  hit_buffer, int(plan.blocked), plan.cap, plan.n_blocks,
                  plan.smem, staged.data_ptr(), plan.width,
                  dropped.data_ptr(), device=dev)
    count_launch(stage_candidates, source)
    return staged, dropped


reset_counts(stage_candidates)  # fused kernels A and B (one block per row)


def read_hits_staged(staged: torch.Tensor, lib_codes: torch.Tensor):
    """Feature rows of staged slots: (hits (R, H) int64, n_hits (R,)
    int32). hits[r, i] = j (window on the canonical strand) or j + L
    (reverse strand) for the first occurrence of a (code, strand) slot whose
    code is library entry j, and the sentinel 2L elsewhere (misses,
    repeats, padding). Rows keep the staged layout (holes, no compaction)."""
    lib_size = lib_codes.shape[0]
    sentinel = 2 * lib_size
    valid = staged != PAD_SLOT
    repeat = torch.zeros_like(valid)
    repeat[:, 1:] = staged[:, 1:] == staged[:, :-1]
    codes = staged >> 1
    pos = torch.searchsorted(lib_codes, codes)
    pos_c = pos.clamp(max=max(lib_size - 1, 0))
    if lib_size:
        found = valid & ~repeat & (lib_codes[pos_c] == codes)
    else:
        found = torch.zeros_like(valid)
    is_fwd = (staged & 1) == 1
    feat = torch.where(is_fwd, pos_c, pos_c + lib_size)
    hits = torch.where(found, feat, sentinel)
    return hits, found.sum(dim=1).to(torch.int32)
