"""Capability probes of the card: the counterparts of the Mosaic probes in
`bench/probe_mosaic.py` (P1-P4) and `bench/probe_mosaic2.py` (P5, P6).

    python -m fedrann_tpu_torch.probes [smem|input|dyn|bsearch|variants|all]

`smem`, `input`, `dyn` and `bsearch` are the probes of probe_mosaic.py;
`variants` runs probe_mosaic2.py's two (P5 and the P6 variants A, B, C).
Each probe prints one line in the scripts' wording (OK or FAIL, the value,
the time) and returns its output tensor. On the card the probes time the
access patterns of the staging and embed kernels:
  P1 how much dynamic shared memory one block may hold (kernel B's sort
     buffer): sizes up to the opt-in limit return n, the first size past it
     is refused and the ladder stops;
  P2/P5 a 128 KB input block staged in shared memory per grid step;
  P3/P6 the dynamic-row gather-accumulate e[row[i]] += q[idx[i]] of kernel
     C (P3: two grid steps; P6 A: fixed output row, B: dynamic-row store,
     C: one step);
  P4 kernel C's lookup, a lower-bound binary search in a sorted table.
Inputs come from `probe_inputs()`: the scripts' numpy arrays and seeds.
Each kernel (csrc/probes.cu) has a plain PyTorch version beside it, which
CPU tensors take; the entry point runs on a CUDA device only.

The P3/P6 kernel sums every output cell over its own row's hits in hit
order (`dyn_rows_order`: a stable bucketing by row, or all hits into row 0
in mode A), the TPU's sequential order, so on the card it equals
`_dyn_rows_replay`, that schedule replayed on tensors, bitwise; the plain
`index_add_` version agrees within a sum-order tolerance.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.device import get_device, shared_memory_limit

# P1 scratch sizes in int32 entries (16 KB .. 1 MB), probe_mosaic.py:26
SCRATCH_SIZES = (1 << 12, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18)
INPUT_ROWS = 16     # P2/P5 rows per grid step (rb)
E_ROWS = 256        # P3/P6 output rows (rb)
# P4's schedule (csrc/probes.cu BS_THREADS, BS_PER): threads a block, and
# queries a thread searches in lockstep, strided by the block
BSEARCH_THREADS, BSEARCH_PER = 128, 4
# P3/P6 mode -> (source row is idx[i], target row is row[i], accumulate,
# passes over the hits): probe_mosaic.py:77-89, probe_mosaic2.py:76-114
DYN_MODES = {
    "P3": (True, True, True, 2),
    "A": (True, False, True, 1),
    "B": (False, True, False, 1),
    "C": (True, True, True, 1),
}
CHOICES = ("smem", "input", "dyn", "bsearch", "variants", "all")


def probe_inputs() -> dict[str, np.ndarray]:
    """Every probe's inputs, made as the JAX scripts make them."""
    rb, hb = INPUT_ROWS, 2048
    tile, d, nh = 512, 1024, 4096
    n, nq = 1 << 13, 1 << 14
    return {
        "x": np.arange(4 * rb * hb, dtype=np.int32).reshape(4 * rb, hb),
        "q": np.random.default_rng(0).normal(size=(tile, d)).astype(
            np.float32),
        "idx": np.random.default_rng(1).integers(0, tile, nh,
                                                 dtype=np.int32),
        "row": np.random.default_rng(2).integers(0, E_ROWS, nh,
                                                 dtype=np.int32),
        "table": np.sort(np.random.default_rng(0).integers(
            0, 1 << 30, n, dtype=np.int32)),
        "queries": np.random.default_rng(1).integers(0, 1 << 30, nq,
                                                     dtype=np.int32),
    }


def _check_int32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("probe inputs must be contiguous int32 tensors")


# ---- P1: shared-memory scratch --------------------------------------------

def _smem_scratch_plain(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((1, 1), n, dtype=torch.int32, device=device)


def smem_scratch(n: int, device: torch.device) -> torch.Tensor:
    """(1, 1) int32 = n from a block holding n int32 of shared memory; on
    a CUDA device a size past the opt-in limit raises RuntimeError. The
    launch path is a few microseconds of host work against ~1 us of device
    work, so it is kept lean: sizes as separate ints (a shape tuple costs
    torch.empty ~1 us more) and the raw stream handle."""
    if device.type == "cpu":
        return _smem_scratch_plain(n, device)
    out = torch.empty(1, 1, dtype=torch.int32, device=device)
    _build.launch("fk_probe_smem_scratch", n, out.data_ptr(), device=device)
    smem_scratch.launches += 1
    return out


smem_scratch.launches = 0


@dataclasses.dataclass
class ScratchStep:
    """One size of the P1 ladder."""

    n: int                        # int32 entries
    out: torch.Tensor | None      # (1, 1) int32, None when refused
    error: str | None             # the refusal


def scratch_ladder_problems(steps: list[ScratchStep],
                            limit: int | None) -> list[str]:
    """What is wrong with a P1 ladder against a limit of `limit` bytes
    (None: no limit, as in the plain version): every size within the limit
    must return n, the first size past it must be refused, and the ladder
    stops there."""
    want = [n for n in SCRATCH_SIZES if limit is None or 4 * n <= limit]
    got = [s.n for s in steps if s.error is None]
    problems = []
    if got != want:
        problems.append(f"sizes accepted {got}, want {want}")
    problems += [f"size {s.n} returned {int(s.out.flatten()[0])}"
                 for s in steps if s.out is not None
                 and int(s.out.flatten()[0]) != s.n]
    if len(want) < len(SCRATCH_SIZES) and (
            len(steps) != len(want) + 1 or steps[-1].error is None):
        problems.append("the ladder did not stop at the first size past "
                        "the limit")
    return problems


def probe_smem_scratch(device: torch.device) -> list[ScratchStep]:
    """P1: the scratch ladder, stopping at the first refused size. On a
    CUDA device the card is used again after the refusal, so an error that
    left the context unusable raises here."""
    steps = []
    for n in SCRATCH_SIZES:
        try:
            out = smem_scratch(n, device)
            _sync(device)
        except RuntimeError as e:
            steps.append(ScratchStep(n, None, str(e)))
            _say(f"[P1] SMEM scratch {n * 4 // 1024:6d} KB: FAIL "
                 f"{str(e)[:120]}")
            break
        ms = _time_ms(lambda n=n: smem_scratch(n, device), device)
        steps.append(ScratchStep(n, out, None))
        _say(f"[P1] SMEM scratch {n * 4 // 1024:6d} KB: OK  "
             f"val={int(out.flatten()[0])}  {ms:.4f} ms")
    if device.type == "cuda":
        again = smem_scratch(SCRATCH_SIZES[0], device)
        if int(again.flatten()[0]) != SCRATCH_SIZES[0]:
            raise RuntimeError("P1: the card gave a wrong value after the "
                               "refused size")
    return steps


# ---- P2 / P5: an input block staged in shared memory ----------------------

def _smem_input_plain(x: torch.Tensor) -> torch.Tensor:
    steps, hb = x.shape[0] // INPUT_ROWS, x.shape[1]
    i = torch.arange(INPUT_ROWS, device=x.device)
    sums = x.reshape(steps, INPUT_ROWS, hb)[:, i, i & 1023].sum(dim=1,
                                                          dtype=torch.int32)
    return sums[-1:]


def smem_input(x: torch.Tensor) -> torch.Tensor:
    """(1,) int32: the last grid step's sum of x_blk[i, i & 1023], i <
    INPUT_ROWS, over the (INPUT_ROWS, hb) blocks of x (int32 wraparound).
    On the card each step's block is staged whole in one block's shared
    memory by 16-byte loads. The launch path is kept lean, as P1's: the
    kernel writes only the last step's sum (no slice of a (steps,)
    tensor), allocated by an int size, not a shape tuple."""
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D int32 tensor")
    rows, hb = x.shape
    if rows % INPUT_ROWS or hb < INPUT_ROWS:
        raise ValueError(f"x ({rows}, {hb}) is not a stack of "
                         f"({INPUT_ROWS}, hb) blocks with hb >= {INPUT_ROWS}")
    if x.is_cpu:
        return _smem_input_plain(x)
    sums = torch.empty(1, dtype=torch.int32, device=x.device)
    _build.launch("fk_probe_smem_input", x.data_ptr(), rows // INPUT_ROWS,
                  INPUT_ROWS, hb, sums.data_ptr(), 1, device=x.device)
    smem_input.launches += 1
    return sums


smem_input.launches = 0


# ---- P3 / P6: dynamic-row gather-accumulate --------------------------------

def _dyn_rows_plain(q: torch.Tensor, idx: torch.Tensor, row: torch.Tensor,
                    mode: str) -> torch.Tensor:
    src_dyn, dst_dyn, accumulate, steps = DYN_MODES[mode]
    nh = idx.shape[0]
    e = torch.zeros((E_ROWS, q.shape[1]), dtype=torch.float32,
                    device=q.device)
    src = q[idx.long()] if src_dyn else q[:1].expand(nh, -1)
    dst = row.long() if dst_dyn else torch.zeros(nh, dtype=torch.int64,
                                                 device=q.device)
    for _ in range(steps):
        if accumulate:
            e.index_add_(0, dst, src)
        else:  # mode B: every hit stores q[0], so the order is immaterial
            e[dst] = src
    return e


def dyn_rows_order(row: torch.Tensor, mode: str) -> list[torch.Tensor]:
    """Each output row's hits (int64 hit indices) in the order the kernel
    takes them: a stable bucketing of `row` in the dynamic-row modes (P3,
    B, C), and every hit, in order, into row 0 in mode A."""
    if DYN_MODES[mode][1]:
        rows = row.long()
        counts = torch.bincount(rows, minlength=E_ROWS)
        return list(torch.split(torch.argsort(rows, stable=True),
                                counts.tolist()))
    none = torch.zeros(0, dtype=torch.int64, device=row.device)
    return ([torch.arange(row.shape[0], device=row.device)]
            + [none] * (E_ROWS - 1))


def _dyn_rows_replay(q: torch.Tensor, idx: torch.Tensor, row: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """The kernel's schedule replayed on tensors, a test oracle and not the
    plain version: e from zero, then each pass walks every row's hits in
    `dyn_rows_order` (hit j of every row at step j), adding the source q
    row in float32 (or storing it in mode B), so each cell's value is
    taken in the same order as the kernel's."""
    src_dyn, _, accumulate, steps = DYN_MODES[mode]
    lists = dyn_rows_order(row, mode)
    width = max(len(h) for h in lists)
    hits = torch.full((len(lists), width), -1, dtype=torch.int64,
                      device=row.device)
    for r, h in enumerate(lists):
        hits[r, :len(h)] = h
    src = idx.long() if src_dyn else torch.zeros_like(idx, dtype=torch.int64)
    e = torch.zeros((E_ROWS, q.shape[1]), dtype=torch.float32,
                    device=q.device)
    for _ in range(steps):
        for j in range(width):
            rows = (hits[:, j] >= 0).nonzero().squeeze(1)
            v = q[src[hits[rows, j]]]
            e[rows] = e[rows] + v if accumulate else v
    return e


def dyn_rows(q: torch.Tensor, idx: torch.Tensor, row: torch.Tensor,
             mode: str) -> torch.Tensor:
    """(E_ROWS, d) float32 e from zero, then for each pass and each hit i in
    order e[dst] = e[dst] + q[src] (or e[dst] = q[src] in mode B), with src
    = idx[i] or 0 and dst = row[i] (in [0, E_ROWS)) or 0 as DYN_MODES[mode]
    says. On the card every cell is summed in hit order, so the result
    equals `_dyn_rows_replay` bitwise."""
    if mode not in DYN_MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(DYN_MODES)}")
    _check_int32(idx, row)
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("q must be a contiguous 2-D float32 tensor")
    if idx.shape != row.shape or idx.dim() != 1:
        raise ValueError("idx and row must be 1-D of one length")
    if q.device.type == "cpu":
        return _dyn_rows_plain(q, idx, row, mode)
    src_dyn, dst_dyn, accumulate, steps = DYN_MODES[mode]
    e = torch.empty((E_ROWS, q.shape[1]), dtype=torch.float32,
                    device=q.device)
    _build.launch("fk_probe_dyn_rows", q.data_ptr(), q.shape[1],
                  idx.data_ptr(), row.data_ptr(), idx.shape[0], E_ROWS,
                  int(src_dyn), int(dst_dyn), int(accumulate), steps,
                  e.data_ptr(), device=q.device)
    dyn_rows.launches += 1
    return e


dyn_rows.launches = 0


# ---- P4: binary search in a sorted table -----------------------------------

def _bsearch_plain(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    pos = torch.searchsorted(table, queries, side="left")
    return pos.sum().to(torch.int32).reshape(1)


def bsearch(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(1,) int32: the sum over queries of lower_bound(table, query) (int32
    wraparound), for a sorted table of n >= 0 entries. On the card the C
    entry zeroes the output on the stream (cudaMemsetAsync) before the
    kernel adds to it, cheaper on the host than torch.zeros."""
    _check_int32(table, queries)
    if table.is_cpu:
        return _bsearch_plain(table, queries)
    out = torch.empty(1, dtype=torch.int32, device=table.device)
    _build.launch("fk_probe_bsearch", table.data_ptr(), table.shape[0],
                  queries.data_ptr(), queries.shape[0], out.data_ptr(),
                  device=table.device)
    bsearch.launches += 1
    return out


bsearch.launches = 0

BSEARCH_EDGE_SIZES = (1, 2, 3, 8191, 8192, 8193)


def bsearch_edge_cases(seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """(sorted int32 table, int32 queries) for each n of BSEARCH_EDGE_SIZES,
    the cases P4's kernel is held on beside the probe inputs: runs of equal
    entries (at the start, the end and, for n > 100, a run of 100 in the
    middle), int32's extremes in the tables of 8,192 and 8,193, and queries
    below the minimum, above the maximum, equal to every kind of entry
    (first, last, in a run, random) and between entries."""
    rng = np.random.default_rng(seed)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    cases = []
    for n in BSEARCH_EDGE_SIZES:
        t = np.sort(rng.integers(-4 * n, 4 * n, n)).astype(np.int64)
        if n >= 2:
            t[1] = t[0]
        if n >= 4:
            t[-1] = t[-2]
        if n > 100:
            t[n // 2 : n // 2 + 100] = t[n // 2]
        if n == 8192:
            t[:3] = lo
        if n == 8193:
            t[-3:] = hi
        picks = t[rng.integers(0, n, 4)]
        q = np.concatenate([
            [max(t[0] - 1, lo), t[0], t[-1], min(t[-1] + 1, hi), lo, hi,
             t[n // 2], t[n // 2] + 1, t[(n - 1) // 3]], picks, picks - 1])
        cases.append((t.astype(np.int32),
                      np.clip(q, lo, hi).astype(np.int32)))
    return cases


WRAPPERS = {"fk_probe_smem_scratch": smem_scratch,
            "fk_probe_smem_input": smem_input,
            "fk_probe_dyn_rows": dyn_rows,
            "fk_probe_bsearch": bsearch}


# ---- the entry point -------------------------------------------------------

def _say(line: str) -> None:
    print(line, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median milliseconds of `reps` single calls of fn (CUDA events on the
    card, the host clock on the CPU), as the scripts time them."""
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[reps // 2]


def run(which: str, device: torch.device) -> dict:
    """Run the probes `which` names on `device`, print one line each, and
    return {"P1": [ScratchStep], "P2": .., "P3": .., "P4": .., "P5": ..,
    "P6": {"A": .., "B": .., "C": ..}} for the probes run."""
    if which not in CHOICES:
        raise ValueError(f"unknown probe {which!r}: one of {CHOICES}")
    t = {k: torch.from_numpy(v).to(device) for k, v in probe_inputs().items()}
    res: dict = {}
    kb = INPUT_ROWS * t["x"].shape[1] * 4 // 1024
    if which in ("smem", "all"):
        res["P1"] = probe_smem_scratch(device)
    if which in ("input", "all"):
        res["P2"] = smem_input(t["x"])
        ms = _time_ms(lambda: smem_input(t["x"]), device)
        _say(f"[P2] SMEM input block ({INPUT_ROWS},{t['x'].shape[1]}) = "
             f"{kb} KB: OK  val={int(res['P2'][0])}  {ms:.4f} ms")
    if which in ("dyn", "all"):
        res["P3"] = dyn_rows(t["q"], t["idx"], t["row"], "P3")
        ms = _time_ms(lambda: dyn_rows(t["q"], t["idx"], t["row"], "P3"),
                      device)
        n_rmw = 2 * t["idx"].shape[0]
        _say(f"[P3] dyn-sublane RMW: OK  sum={float(res['P3'].sum()):.6g}  "
             f"{ms * 1e3:.1f} us for {n_rmw} RMW "
             f"({ms * 1e6 / n_rmw:.1f} ns each)")
    if which in ("bsearch", "all"):
        res["P4"] = bsearch(t["table"], t["queries"])
        ms = _time_ms(lambda: bsearch(t["table"], t["queries"]), device)
        nq = t["queries"].shape[0]
        steps = t["table"].shape[0].bit_length()  # the kernel's fixed steps
        _say(f"[P4] scalar bsearch ({steps} steps): OK  "
             f"val={int(res['P4'][0])}  {ms:.4f} ms for {nq} queries "
             f"({ms * 1e6 / nq:.1f} ns/query)")
    if which in ("variants", "all"):
        res["P5"] = smem_input(t["x"])
        ms = _time_ms(lambda: smem_input(t["x"]), device)
        _say(f"[P5] SMEM input block ({INPUT_ROWS},{t['x'].shape[1]}): OK "
             f"val={int(res['P5'][0])}  {ms:.4f} ms")
        res["P6"] = {}
        for mode, label in (("A", "dyn-load + fixed-row RMW"),
                            ("B", "dyn-row store"),
                            ("C", "dyn-load + dyn-row RMW")):
            res["P6"][mode] = dyn_rows(t["q"], t["idx"], t["row"], mode)
            ms = _time_ms(lambda m=mode: dyn_rows(t["q"], t["idx"],
                                                  t["row"], m), device)
            _say(f"[P6] {mode}: {label}: OK  "
                 f"sum={float(res['P6'][mode].sum()):.6g}  "
                 f"{ms * 1e3:.1f} us")
    _sync(device)
    return res


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    which = args[0] if args else "all"
    if len(args) > 1 or which not in CHOICES:
        print(f"usage: python -m fedrann_tpu_torch.probes "
              f"[{'|'.join(CHOICES)}]", file=sys.stderr)
        return 2
    device = get_device("cuda")
    print(f"device: {torch.cuda.get_device_name(device)}", file=sys.stderr)
    res = run(which, device)
    problems = scratch_ladder_problems(
        res["P1"], shared_memory_limit(device)) if "P1" in res else []
    for p in problems:
        print(f"[P1] FAIL: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
