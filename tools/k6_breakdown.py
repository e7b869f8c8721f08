#!/usr/bin/env python3
"""Where K6's time goes, on one CUDA card:

    python3 tools/k6_breakdown.py

Builds fedrann_tpu_torch/csrc/ivf_rescore.cu four more times with parts of
K6's bf16 form switched off (source hooks, each must match once), each by
nvcc into its own library under fedrann_tpu_torch/_kernels/k6_breakdown/
(all builds at once), and times fk_ivf_rescore of each on chip_smoke.py
phase 11b's tables: 262,144 x 512 read-overlap rows (overlap_rows, FLAGS'
--seed) with knn_ivf's C = 1,024, p = 8, spill 2, k = 50:
  - full: the kernel as it is, with the merges and survivors it counts;
  - no_offer: the product, the loads and each tile's scores staged in
    shared memory, but no key offered, so no survivor and no merge;
  - no_product: as full without the mma.sync steps (every score +0.0:
    the first tile's keys fill the lists, later tiles offer nothing);
  - loads: neither the product nor the offers: the gathers, the stage
    pipeline and its barriers.
Each line gives ms per call (CUDA events, 3 calls after a warm-up) and
the TFLOP/s of 2 * 512 operations a real pair-score; the card's name and
power limit head the output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HOOKS = {
    "#include \"common.cuh\"\n": (
        "#include \"common.cuh\"\n"
        "__device__ unsigned long long g_counts[2];\n"
        "extern \"C\" int bd_counts(unsigned long long* out, int reset) {\n"
        "  unsigned long long z[2] = {0, 0};\n"
        "  return reset ? (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z))\n"
        "               : (int)cudaMemcpyFromSymbol(out, g_counts,\n"
        "                                           sizeof(z));\n"
        "}\n"),
    "  int64_t* S = rs.sv + r * SV;\n  const int len = rs.len[r];\n": (
        "  int64_t* S = rs.sv + r * SV;\n  const int len = rs.len[r];\n"
        "#ifdef BD_COUNT\n"
        "  if (lane == 0) { atomicAdd(&g_counts[0], 1ull);\n"
        "    atomicAdd(&g_counts[1], (unsigned long long)rs.cnt[r]); }\n"
        "#endif\n"),
    "      offer_half(rs, sc, half, mq, col0, nm, mem, n_real);\n": (
        "#ifndef BD_NO_OFFER\n"
        "      offer_half(rs, sc, half, mq, col0, nm, mem, n_real);\n"
        "#endif\n"),
    ("            mma_bf16(acc + (mi * 8 + ni) * 4, a[mi],\n"
     "                     bf[ni >> 1][(ni & 1) * 2], "
     "bf[ni >> 1][(ni & 1) * 2 + 1]);\n"): (
        "#ifndef BD_NO_PRODUCT\n"
        "            mma_bf16(acc + (mi * 8 + ni) * 4, a[mi],\n"
        "                     bf[ni >> 1][(ni & 1) * 2], "
        "bf[ni >> 1][(ni & 1) * 2 + 1]);\n"
        "#endif\n"),
}
VARIANTS = {"full": ["-DBD_COUNT"], "no_offer": ["-DBD_NO_OFFER"],
            "no_product": ["-DBD_NO_PRODUCT", "-DBD_COUNT"],
            "loads": ["-DBD_NO_PRODUCT", "-DBD_NO_OFFER"]}


def build(out_dir: str) -> dict:
    from fedrann_tpu_torch import _build

    csrc = str(_build._CSRC)
    with open(os.path.join(csrc, "ivf_rescore.cu")) as f:
        src = f.read()
    for old, new in HOOKS.items():
        if src.count(old) != 1:
            sys.exit(f"k6_breakdown: the hook {old!r} is not in "
                     "ivf_rescore.cu")
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
        fn = libs[name].fk_ivf_rescore
        fn.argtypes = _build._SIGNATURES["fk_ivf_rescore"]
        fn.restype = ctypes.c_int
    return libs


def main() -> None:
    import torch

    import chip_smoke as cs
    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.knn import ivf

    if not torch.cuda.is_available():
        sys.exit("k6_breakdown: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    libs = build(os.path.join(_build.BUILD_DIR, "k6_breakdown"))
    dev = torch.device("cuda")
    rows = cs.overlap_rows(cs.IVF_ROWS, dev)
    case = cs.ivf_case(ivf._unit_padded(rows, "bf16"), cs.IVF_ROWS, 1024, 8,
                       2)
    del rows
    want = cs.k6_run(case, "bf16")
    en = case["en_pad"].to(torch.bfloat16)
    units = torch.from_numpy(ivf.rescore_units(
        case["counts_h"], case["qcounts_h"])).to(dev)
    buf = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    ops = 2 * 512 * case["real"]
    for name, lib in libs.items():
        def call(lib=lib):
            rc = lib.fk_ivf_rescore(
                en.data_ptr(), 512, 1, case["member"].data_ptr(),
                case["member"].shape[1], case["qtab"].data_ptr(),
                case["stab"].data_ptr(), case["qtab"].shape[1],
                units.data_ptr(), units.shape[0], 0, case["n_real"],
                case["p"], case["kk_g"], buf.data_ptr(), 1, stream)
            if rc:
                sys.exit(f"k6_breakdown: {name} launch failed ({rc})")

        ms = cs.time_cuda(call, 3)
        text = (f"{name} at 11b's {cs.IVF_ROWS} x 512 rows, C = 1,024, "
                f"{case['real']} real pair-scores, {units.shape[0]} units: "
                f"{ms:.3f} ms = {ops / ms / 1e9:.1f} TFLOP/s")
        if name == "full" and not torch.equal(buf, want):
            sys.exit("k6_breakdown: the full build differs from K6")
        if "-DBD_COUNT" in VARIANTS[name]:
            counts = (ctypes.c_ulonglong * 2)()
            lib.bd_counts(counts, 1)
            call()
            torch.cuda.synchronize()
            lib.bd_counts(counts, 0)
            lists = case["nq"] * case["p"]
            text += (f"; {counts[0] / lists:.2f} merges and "
                     f"{counts[1] / lists:.1f} survivors a (query, slot) "
                     "list")
        print(text, flush=True)


if __name__ == "__main__":
    main()
