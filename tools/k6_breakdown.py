#!/usr/bin/env python3
"""Where K6's time goes, on one CUDA card:

    python3 tools/k6_breakdown.py [--shape 11b|cell|both] [--seed N]

Builds fedrann_tpu_torch/csrc/ivf_rescore.cu five more times, four with
parts of K6's bf16 form switched off and one with counters (source hooks,
each must match once), each by nvcc into its own library under
fedrann_tpu_torch/_kernels/k6_breakdown/ (all builds at once), and times
fk_ivf_rescore of each on one or both shapes:
  - 11b (the default): chip_smoke.py phase 11b's tables, 262,144 x 512
    read-overlap rows (overlap_rows, FLAGS' --seed) with knn_ivf's C =
    1,024, p = 8, spill 2, k = 50;
  - cell: the benchmark cell ont-chr1.ivf's rows (portbench's generator
    at portbench/configs/ont-chr1.json, read set --seed): 1,493,738 x 500,
    C = 2,048 (auto_clusters), p = 8, spill 2, k = 50, so ~2,300 members a
    probed cluster;
and for each build:
  - full: the kernel as it is;
  - no_select: the product, the loads and the first two tiles' scores
    stored in shared memory, but no selection, no offer and no merge;
  - no_product: as full without the wgmma steps (every score +0.0, so
    every key ties and the bisection walks the low words);
  - loads: neither the product nor the selection: the gathers, the stage
    pipeline and its barriers;
  - counts (not timed: its counters are global atomics): the first
    selection's bisection steps, the keys emitted (kept by the first
    selection or merged from the survivor slots) and the merges, each a
    (query, slot) list, the warps' tiles that overflowed a row's slots,
    and clock64 cycles a warp a unit in each part (CYCLES).
The rows go in as rescore_clusters makes them. Each line gives ms per
call (CUDA events, 3 calls after a warm-up) and the TFLOP/s of 2 d
operations a real pair-score. Then the members a unit (the quantiles),
and K7 on K6's buffer (the package's build, spill 2 and 1) beside
torch.topk of the buffer rows (spill 1's function), with the rows its
exact finish took (the counts build's K7). The card's name and power
limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# steps, emitted, merges, overflowing tiles, exact K7 rows; then clock64
# cycles (each warp's lane 0): the first selection, the offers, the
# overflow rounds, the merges after a tile, the last merges and write-out,
# the whole block
N_COUNTS = 11
CYCLES = ("first selection", "offers", "overflow rounds", "merges after a "
          "tile", "last merges and write-out", "whole unit")
HOOKS = {
    "#include \"keys_sm90.cuh\"\n": (
        "#include \"keys_sm90.cuh\"\n"
        f"__device__ unsigned long long g_counts[{N_COUNTS}];\n"
        "extern \"C\" int bd_counts(unsigned long long* out, int reset) {\n"
        f"  unsigned long long z[{N_COUNTS}] = {{0}};\n"
        "  return reset ? (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z))\n"
        "               : (int)cudaMemcpyFromSymbol(out, g_counts,\n"
        "                                           sizeof(z));\n"
        "}\n"
        "#ifdef BD_COUNT\n"
        "#define BD_ADD(i, n) atomicAdd(&g_counts[i], "
        "(unsigned long long)(n))\n"
        "#define BD_T0(v) const long long v = clock64()\n"
        "#define BD_T(i, v) if ((threadIdx.x & 31) == 0) "
        "BD_ADD(i, clock64() - v)\n"
        "#else\n"
        "#define BD_ADD(i, n)\n"
        "#define BD_T0(v)\n"
        "#define BD_T(i, v)\n"
        "#endif\n"),
    "  for (int r = threadIdx.x; r < BM; r += THREADS) {\n": (
        "  BD_T0(bd_k);\n"
        "  for (int r = threadIdx.x; r < BM; r += THREADS) {\n"),
    "      int most = 0;\n": (
        "      BD_T0(bd_o);\n"
        "      int most = 0;\n"),
    "      if (__any_sync(0xffffffffu, most > SV)) {\n": (
        "      BD_T(6, bd_o);\n"
        "      BD_T0(bd_v);\n"
        "      if (__any_sync(0xffffffffu, most > SV)) {\n"),
    "      merge_rows<LS>(u, r0w, SV / 2, lane);\n": (
        "      BD_T(7, bd_v);\n"
        "      BD_T0(bd_m);\n"
        "      merge_rows<LS>(u, r0w, SV / 2, lane);\n"
        "      BD_T(8, bd_m);\n"),
    "  merge_rows<LS>(u, r0w, 0, lane);\n": (
        "  BD_T0(bd_f);\n"
        "  merge_rows<LS>(u, r0w, 0, lane);\n"),
    ("      for (int e = n + lane; e < W; e += 32) out[e] = EMPTY_KEY;\n"
     "    }\n  }\n"): (
        "      for (int e = n + lane; e < W; e += 32) out[e] = EMPTY_KEY;\n"
        "    }\n  }\n"
        "  BD_T(9, bd_f);\n"
        "  BD_T(10, bd_k);\n"),
    "    const int32_t mid = static_cast<int32_t>(a + ((b - a) >> 1));\n": (
        "    const int32_t mid = static_cast<int32_t>(a + ((b - a) >> 1));\n"
        "    if ((threadIdx.x & 7) == 0 && go) BD_ADD(0, 1);\n"),
    "    const uint64_t mid = x + ((y - x) >> 1);\n": (
        "    const uint64_t mid = x + ((y - x) >> 1);\n"
        "    if ((threadIdx.x & 7) == 0 && !done) BD_ADD(0, 1);\n"),
    "    if (live && j == 0) u.len[r] = need;\n": (
        "    if (live && j == 0) u.len[r] = need;\n"
        "    if (live && j == 0) BD_ADD(1, need);\n"),
    "  const int n = live ? u.len[rr] : 0;\n": (
        "  const int n = live ? u.len[rr] : 0;\n"
        "  if (live && j == 0) BD_ADD(2, 1);\n"
        "  if (live && j == 0) BD_ADD(1, s);\n"),
    "  const int s = min(u.cnt[r], SV_DEV), len = u.len[r];\n": (
        "  const int s = min(u.cnt[r], SV_DEV), len = u.len[r];\n"
        "  if (lane == 0) BD_ADD(2, 1);\n"
        "  if (lane == 0) BD_ADD(1, s);\n"),
    "        // a row overflowed: drop the tile's keys (its count in shared\n": (
        "        if (lane == 0) BD_ADD(3, 1);\n"
        "        // a row overflowed: drop the tile's keys (its count in shared\n"),
    "  if (!exact) pop_merge(src, p, L, K, dedup, dst, pos, lane);\n": (
        "  if (!exact && lane == 0) BD_ADD(4, 1);\n"
        "  if (!exact) pop_merge(src, p, L, K, dedup, dst, pos, lane);\n"),
    "      if (t == t_sel) select_first<LS>(u, r0w, lane);\n": (
        "#ifndef BD_NO_SELECT\n"
        "      if (t == t_sel) {\n"
        "        BD_T0(bd_s);\n"
        "        select_first<LS>(u, r0w, lane);\n"
        "        BD_T(5, bd_s);\n"
        "      }\n"
        "#endif\n"),
    "  const int32_t mono = mono_bits(v);\n": (
        "#ifdef BD_NO_SELECT\n"
        "  return 0;\n"
        "#endif\n"
        "  const int32_t mono = mono_bits(v);\n"),
    ("        wgmma_m64n128k16(acc, desc_sw128(a + 32 * ks),\n"
     "                         desc_sw128(sp + CHUNK + 32 * ks));\n"): (
        "#ifndef BD_NO_PRODUCT\n"
        "        wgmma_m64n128k16(acc, desc_sw128(a + 32 * ks),\n"
        "                         desc_sw128(sp + CHUNK + 32 * ks));\n"
        "#endif\n"),
}
VARIANTS = {"full": [], "no_select": ["-DBD_NO_SELECT"],
            "no_product": ["-DBD_NO_PRODUCT"],
            "loads": ["-DBD_NO_PRODUCT", "-DBD_NO_SELECT"],
            "counts": ["-DBD_COUNT"]}


def build(out_dir: str) -> dict:
    from fedrann_tpu_torch import _build

    csrc = str(_build._CSRC)
    with open(os.path.join(csrc, "ivf_rescore.cu")) as f:
        src = f.read()
    for old, new in HOOKS.items():
        if src.count(old) != 1:
            sys.exit(f"k6_breakdown: the hook {old!r} is not in "
                     "ivf_rescore.cu once")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "ivf_rescore_breakdown.cu")
    with open(cu, "w") as f:
        f.write(src)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", csrc, "-o",
         os.path.join(out_dir, f"{name}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k6_breakdown: nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for entry in ("fk_ivf_rescore", "fk_ivf_merge"):
            fn = getattr(libs[name], entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
    return libs


def read_counts(lib, call) -> list:
    counts = (ctypes.c_ulonglong * N_COUNTS)()
    lib.bd_counts(counts, 1)
    call()
    import torch

    torch.cuda.synchronize()
    lib.bd_counts(counts, 0)
    return list(counts)


def shape_case(shape: str, seed: int, dev):
    """(label, the rescore's case as chip_smoke.ivf_case makes it, d) of
    one shape (see the module docstring)."""
    import chip_smoke as cs
    from fedrann_tpu_torch.knn import ivf

    if shape == "11b":
        rows = cs.overlap_rows(cs.IVF_ROWS, dev)
        case = cs.ivf_case(ivf._unit_padded(rows, "bf16"), cs.IVF_ROWS,
                           1024, 8, 2)
        return f"11b's {cs.IVF_ROWS} x 512 rows, C = 1,024", case, 512
    from fedrann_tpu_torch.cli import config_from_args
    from portbench.gen import Dataset, Features, make_read_set

    with open(os.path.join(HERE, "portbench", "configs",
                           "ont-chr1.json")) as f:
        cfg = json.load(f)
    config = config_from_args(["-i", "reads.fa", "-o", "out",
                               *cfg["flags"]])
    ds = Dataset(**cfg["dataset"])
    ft = Features(config.kmer_size, config.kmer_sample_fraction,
                  config.kmer_min_multiplicity, config.embedding_dimension,
                  config.projection_density)
    rows = make_read_set(ds, ft, seed, dev).rows
    n, d = rows.shape
    c = ivf.auto_clusters(n)
    case = cs.ivf_case(ivf._unit_padded(rows, config.knn_precision), n, c,
                       config.knn_ivf_probes, config.knn_ivf_spill,
                       config.n_neighbors)
    return (f"ont-chr1's {n} x {d} rows (read set {seed}), C = {c:,}",
            case, d)


def breakdown(libs: dict, label: str, case: dict, d: int) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from fedrann_tpu_torch.knn import ivf
    from fedrann_tpu_torch.knn.topk import _tma_rows

    want = cs.k6_run(case, "bf16")
    en = _tma_rows(case["en_pad"], torch.bfloat16)
    members, queries = case["members"], case["queries"]
    units_h = queries.units[: int(queries.n_units[0])].cpu().numpy()
    buf = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    ops = 2 * d * case["real"]
    lists = case["nq"] * case["p"]
    print(f"{label}: {case['real']} real pair-scores "
          f"({case['real'] / case['nq']:.1f} a row), {len(units_h)} units, "
          f"rows of pitch {en.shape[1]} bf16", flush=True)
    for name, lib in libs.items():
        def call(lib=lib):
            rc = lib.fk_ivf_rescore(
                en.data_ptr(), en.shape[1], 1, members.vals.data_ptr(),
                queries.vals.data_ptr(), queries.slots.data_ptr(),
                queries.units.data_ptr(), queries.n_units.data_ptr(),
                queries.units.shape[0], 0, case["n_real"], case["p"],
                case["kk_g"], buf.data_ptr(), stream)
            if rc:
                sys.exit(f"k6_breakdown: {name} launch failed ({rc})")

        if name == "counts":
            got = read_counts(lib, call)
            steps, emitted, merges, rounds = got[:4]
            if not torch.equal(buf, want):
                sys.exit("k6_breakdown: the counts build differs from K6")
            warps = 8 * len(units_h)
            print(f"counts, a (query, slot) list: "
                  f"{steps / lists:.2f} bisection steps, "
                  f"{emitted / lists:.1f} keys emitted, "
                  f"{merges / lists:.3f} merges; {rounds} warps' tiles "
                  "overflowed; clock64 cycles a warp a unit: " + ", ".join(
                      f"{what} {c / warps:.0f}"
                      for what, c in zip(CYCLES, got[5:])), flush=True)
            continue
        ms = cs.time_cuda(call, 3)
        if name == "full" and not torch.equal(buf, want):
            sys.exit("k6_breakdown: the full build differs from K6")
        print(f"{name}: {ms:.3f} ms = {ops / ms / 1e9:.1f} TFLOP/s",
              flush=True)
    sizes = units_h[:, 3]
    q = np.quantile(sizes, [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
    print(f"members a unit over {len(sizes)} units: min {q[0]:.0f}, "
          f"10% {q[1]:.0f}, median {q[2]:.0f}, 90% {q[3]:.0f}, 99% "
          f"{q[4]:.0f}, max {q[5]:.0f}, mean {sizes.mean():.1f}; past "
          f"the first selection's {ivf.K6_FIRST}: "
          f"{(sizes > ivf.K6_FIRST).mean():.3f} of the units", flush=True)

    # K7 on the full build's buffer
    k = case["k"]
    kk = min(k, want.shape[1] * want.shape[2])
    out = torch.empty((want.shape[0], kk), dtype=torch.int64,
                      device=want.device)
    for spill in (2, 1):
        ms = cs.time_cuda(lambda: ivf.merge_probe_lists(want, k, spill), 5)
        exact = read_counts(libs["counts"], lambda: libs[
            "counts"].fk_ivf_merge(want.data_ptr(), want.shape[0], case["p"],
                                   want.shape[2], kk, spill, out.data_ptr(),
                                   stream))[4]
        if not torch.equal(out, ivf.merge_probe_lists(want, k, spill)):
            sys.exit("k6_breakdown: the counts build's K7 differs from K7")
        print(f"K7 at spill {spill} on the buffer {tuple(want.shape)}: "
              f"{ms:.4f} ms; rows finished exactly {exact} of "
              f"{want.shape[0]}", flush=True)
    flat = want.reshape(want.shape[0], -1)
    topk_ms = cs.time_cuda(lambda: torch.topk(flat, kk, dim=1), 5)
    print(f"torch.topk of the buffer rows (k = {kk}): {topk_ms:.4f} ms",
          flush=True)


def main() -> None:
    import torch

    from fedrann_tpu_torch import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=("11b", "cell", "both"),
                    default="11b")
    ap.add_argument("--seed", type=int, default=2_026_101_825,
                    help="the cell shape's read set")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k6_breakdown: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    libs = build(os.path.join(_build.BUILD_DIR, "k6_breakdown"))
    dev = torch.device("cuda")
    for shape in (("11b", "cell") if args.shape == "both"
                  else (args.shape,)):
        label, case, d = shape_case(shape, args.seed, dev)
        breakdown(libs, label, case, d)
        del case
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
