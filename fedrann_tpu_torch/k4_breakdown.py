"""Where K4's time goes, on one CUDA card.

    python -m fedrann_tpu_torch.k4_breakdown [--fp32]

Builds csrc/knn_merge.cu six more times with parts of the bf16 kernel
(knn_merge_wgmma) switched off, each with nvcc into its own library under
fedrann_tpu_torch/_kernels/breakdown/ (all builds at once), and times
fk_knn_merge of each on bf16 unit rows from a seeded generator, k = 50,
at 15,000 x 15,000, 2,048 x 65,536 and 65,536 x 65,536 (x 512), with the
units knn/topk.py k4_units plans for the card:
  - full: the kernel as it is, with the merges and survivors it counts;
  - global_lists: as full, but each row's list in device memory with 32
    survivor slots, the form K4 takes where k passes 64 (and merged
    through each warp's scratch);
  - no_offer: the product and the filter's first test (each group of 8
    columns' largest score of each row against its threshold, the warp's
    vote), but no key is offered, so no survivor and no merge;
  - no_filter: the product alone (TMA loads, mbarriers, wgmma), the
    accumulators only folded into one word so that the product stays;
  - no_product: the loads and the barriers of the pipeline, no wgmma;
  - clocks: as full, with clock64 read by each consumer warp around the
    filter of each tile (the unit's first four tiles apart: the lists
    fill there) and by the merging warp around each merge of a survivor
    half (in the merge warps, or in a consumer warp on a tile that
    overflows and at a unit's end), averaged.
With --fp32, the fp32 form (knn_merge_ffma) instead, on float32 unit
rows, at 15,000 x 15,000, 65,536 x 65,536 and 2,048 x 262,144 (x 512):
  - ff_full: the kernel as it is, with the merges and survivors it counts;
  - ff_no_offer: the product and each row's first test (its largest score
    of the tile against its threshold, the warp's vote), no key offered;
  - ff_no_filter: the product alone (TMA loads, mbarriers, the FFMA
    steps), the accumulators folded into one word;
  - ff_no_product: the loads and the barriers of the pipeline alone;
  - ff_clocks: as ff_full, clock64 around each consumer warp's filter of
    a tile (a unit's first four tiles apart) and each half merge.
Each line gives ms per call (CUDA events, 3 calls after a warm-up) and
the TFLOP/s of 2 * m * n * 512 operations; the card's name and power limit
head the output. A source edit that no longer matches a hook fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from fedrann_tpu_torch import _build
from fedrann_tpu_torch.knn.topk import k4_units, normalize_rows, sm_count

HOOKS = {
    # the counts of merges and survivors (full)
    "#include \"common.cuh\"\n": (
        "#include \"common.cuh\"\n"
        "__device__ unsigned long long g_counts[8];\n"
        "extern \"C\" int bd_counts(unsigned long long* out, int reset) {\n"
        "  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  return reset ? (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z))\n"
        "               : (int)cudaMemcpyFromSymbol(out, g_counts,\n"
        "                                           sizeof(z));\n"
        "}\n"
        "// a warp's lane 0's cycles in a scope into g_counts[slot], and\n"
        "// one scope into g_counts[slot + 1]\n"
        "struct BdClock {\n"
        "  long long t0; int slot; bool on;\n"
        "  __device__ BdClock(int s, bool o) : t0(0), slot(s), on(o) {\n"
        "#ifdef __CUDA_ARCH__\n    t0 = clock64();\n#endif\n  }\n"
        "  __device__ ~BdClock() {\n#ifdef __CUDA_ARCH__\n"
        "    if (on) {\n      atomicAdd(&g_counts[slot],\n"
        "                (unsigned long long)(clock64() - t0));\n"
        "      atomicAdd(&g_counts[slot + 1], 1ull);\n    }\n"
        "#endif\n  }\n"
        "};\n"),
    "  int64_t v[SV / 32];\n  int rank[SV / 32];\n": (
        "  int64_t v[SV / 32];\n  int rank[SV / 32];\n#ifdef BD_COUNT\n"
        "  if (lane == 0) { atomicAdd(&g_counts[0], 1ull);\n"
        "    atomicAdd(&g_counts[1], (unsigned long long)s); }\n"
        "#endif\n"),
    "        // the filter: each row's largest score against its "
    "threshold\n": (
        "#ifdef BD_NO_FILTER\n"
        "        {  // every accumulator read, so the product stays\n"
        "          uint32_t fold = 0;\n"
        "          for (int i = 0; i < 64; ++i)\n"
        "            fold ^= __float_as_uint(acc[i]);\n"
        "          if (fold == 0x9e3779b9u) out[0] = 0;\n"
        "          continue;\n        }\n#endif\n"
        "#ifdef BD_CLOCKS\n"
        "        BdClock bd_filter(t - x.t_lo < 4 ? 2 : 4, lane == 0);\n"
        "#endif\n"
        "        // the filter: each row's largest score against its "
        "threshold\n"),
    "          int most = -1;\n#pragma unroll\n"
    "          for (int j = 0; j < 16; ++j) {\n": (
        "#ifdef BD_NO_OFFER\n"
        "          {  // the first test of every group, and the warp's vote\n"
        "            bool pass = false;\n"
        "            for (int j = 0; j < 16; ++j) {\n"
        "              pass |= !(max_nan(acc[4 * j], acc[4 * j + 1])\n"
        "                        < ta.f) ||\n"
        "                      !(max_nan(acc[4 * j + 2], acc[4 * j + 3])\n"
        "                        < tb.f);\n"
        "            }\n"
        "            if (__any_sync(0xffffffffu, pass)) out[0] = ca + cb;\n"
        "            continue;\n          }\n#endif\n"
        "          int most = -1;\n#pragma unroll\n"
        "          for (int j = 0; j < 16; ++j) {\n"),
    "  const int s = min(R.cnt[2 * r + h], SVH);\n": (
        "  const int s = min(R.cnt[2 * r + h], SVH);\n#ifdef BD_COUNT\n"
        "  if (lane == 0) { atomicAdd(&g_counts[0], 1ull);\n"
        "    atomicAdd(&g_counts[1], (unsigned long long)s); }\n"
        "#endif\n#ifdef BD_CLOCKS\n  BdClock bd_merge(6, lane == 0);\n"
        "#endif\n"),
    "          wgmma_fence();\n": (
        "#ifndef BD_NO_PRODUCT\n          wgmma_fence();\n"),
    "          wgmma_commit();\n": (
        "          wgmma_commit();\n#endif\n"),
}
# the fp32 form's hooks (knn_merge_ffma), applied with HOOKS
FF_HOOKS = {
    "  constexpr int STEPS = ROW / (4 * static_cast<int>(sizeof(T)));\n": (
        "#ifdef BD_FF_NO_PRODUCT\n  constexpr int STEPS = 0;\n#else\n"
        "  constexpr int STEPS = ROW / (4 * static_cast<int>(sizeof(T)));\n"
        "#endif\n"),
    "      // the tile's keys: each of the thread's rows tested once at its\n": (
        "#ifdef BD_FF_NO_FILTER\n"
        "      {  // every accumulator read, so the product stays\n"
        "        uint32_t fold = 0;\n"
        "        for (int i = 0; i < 64; ++i) fold ^= __float_as_uint(acc[i]);\n"
        "        if (fold == 0x9e3779b9u) out[0] = 0;\n"
        "        continue;\n      }\n#endif\n"
        "#ifdef BD_FF_NO_OFFER\n"
        "      {  // each row's first test, and the warp's vote\n"
        "        bool pass = false;\n"
        "        for (int i = 0; i < 8; ++i) {\n"
        "          const int r = ra + 2 * i;\n"
        "          float top = acc[i * 8];\n"
        "          for (int j = 1; j < 8; ++j)\n"
        "            top = tc::max_nan(top, acc[i * 8 + j]);\n"
        "          const tc::Thr th = LS ? tc::thr_of(tc::ld_volatile(\n"
        "              &R.thr[r]), x.row0 + r < m)\n"
        "              : tc::load_thr(rs, r, x.row0 + r < m);\n"
        "          pass |= !(top < th.f);\n"
        "        }\n"
        "        if (__any_sync(0xffffffffu, pass)) out[0] = 0;\n"
        "        continue;\n      }\n#endif\n"
        "#ifdef BD_CLOCKS\n"
        "      BdClock bd_filter(t - x.t_lo < 4 ? 2 : 4, lane == 0);\n"
        "#endif\n"
        "      // the tile's keys: each of the thread's rows tested once at its\n"),
}
FF_VARIANTS = {"ff_full": ["-DBD_COUNT"],
               "ff_no_offer": ["-DBD_FF_NO_OFFER"],
               "ff_no_filter": ["-DBD_FF_NO_FILTER"],
               "ff_no_product": ["-DBD_FF_NO_PRODUCT", "-DBD_FF_NO_FILTER"],
               "ff_clocks": ["-DBD_CLOCKS"]}
FF_SHAPES = ((15000, 15000), (65536, 65536), (2048, 262144))
VARIANTS = {"full": ["-DBD_COUNT"],
            "global_lists": ["-DBD_COUNT", "-DK4_GLOBAL_LISTS"],
            "no_offer": ["-DBD_NO_OFFER"],
            "no_filter": ["-DBD_NO_FILTER"],
            "no_product": ["-DBD_NO_PRODUCT", "-DBD_NO_FILTER"],
            "clocks": ["-DBD_CLOCKS"]}
SHAPES = ((15000, 15000), (2048, 65536), (65536, 65536))


def build(out_dir: str, variants: dict = VARIANTS) -> dict:
    csrc = str(_build._CSRC)
    with open(os.path.join(csrc, "knn_merge.cu")) as f:
        src = f.read()
    for old, new in {**HOOKS, **FF_HOOKS}.items():
        if src.count(old) != 1:
            sys.exit(f"k4_breakdown: the hook {old!r} is not in knn_merge.cu")
        src = src.replace(old, new)
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "knn_merge_breakdown.cu")
    with open(cu, "w") as f:
        f.write(src)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", csrc, "-o",
         os.path.join(out_dir, f"{name}.so"), cu,
         os.path.join(csrc, "canonical_sample.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in variants.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k4_breakdown: nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        fn = libs[name].fk_knn_merge
        fn.argtypes = _build._SIGNATURES["fk_knn_merge"]
        fn.restype = ctypes.c_int
    return libs


def time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--fp32"]):
        sys.exit(f"usage: python -m fedrann_tpu_torch.k4_breakdown [--fp32], "
                 f"not {argv}")
    fp32 = argv == ["--fp32"]
    variants, shapes = ((FF_VARIANTS, FF_SHAPES) if fp32
                        else (VARIANTS, SHAPES))
    if not torch.cuda.is_available():
        sys.exit("k4_breakdown: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    libs = build(os.path.join(_build.BUILD_DIR, "breakdown"), variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = normalize_rows(torch.randn((max(n for _, n in shapes), 512),
                                      device=dev, generator=gen))
    if not fp32:
        rows = rows.to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        for m, n in shapes:
            q, c = rows[:m], rows[:n]
            out = torch.empty((m, 50), dtype=torch.int64, device=dev)
            units = k4_units(m, n, 50, sm_count(dev))
            parts = torch.empty((units, m, 50), dtype=torch.int64,
                                device=dev)

            def call(lib=lib, q=q, c=c, m=m, n=n, out=out, units=units,
                     parts=parts):
                rc = lib.fk_knn_merge(q.data_ptr(), m, c.data_ptr(), n, 512,
                                      int(not fp32), int(fp32), 0, None,
                                      None, 0, 50,
                                      out.data_ptr(), 1, units,
                                      parts.data_ptr(), stream)
                if rc:
                    sys.exit(f"k4_breakdown: {name} launch failed ({rc})")

            ms = time_ms(call)
            text = (f"{name} {m} x {n} x 512, k = 50, {units} units: "
                    f"{ms:.3f} ms = {2 * m * n * 512 / ms / 1e9:.1f} TFLOP/s")
            if "-DBD_COUNT" in variants[name]:
                counts = (ctypes.c_ulonglong * 8)()
                lib.bd_counts(counts, 1)
                call()
                torch.cuda.synchronize()
                lib.bd_counts(counts, 0)
                text += (f"; {counts[0] / m:.1f} merges and "
                         f"{counts[1] / m:.1f} survivors a row")
            if name in ("clocks", "ff_clocks"):
                counts = (ctypes.c_ulonglong * 8)()
                lib.bd_counts(counts, 1)
                call()
                torch.cuda.synchronize()
                lib.bd_counts(counts, 0)
                text += "; cycles a warp: " + ", ".join(
                    f"{what} {counts[i] / max(counts[i + 1], 1):.0f} x "
                    f"{counts[i + 1]}" for what, i in (
                        ("filter, first 4 tiles", 2),
                        ("filter, later tiles", 4), ("half merge", 6)))
            print(text, flush=True)


if __name__ == "__main__":
    main()
