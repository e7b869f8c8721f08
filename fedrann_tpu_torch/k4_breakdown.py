"""Where K4's time goes, on one CUDA card.

    python -m fedrann_tpu_torch.k4_breakdown

Builds csrc/knn_merge.cu three more times with parts switched off, each
with nvcc into its own library under fedrann_tpu_torch/_kernels/breakdown/
(all four builds at once), and times fk_knn_merge of each on bf16 unit
rows from a seeded generator, k = 50, at 15,000 x 15,000, 2,048 x 65,536
and 65,536 x 65,536 (x 512):
  - full: the kernel as it is, with the merges and survivors it counts;
  - no_scan: the product and the staging of each column half, but no scan
    of the staged scores, so no survivor and no merge;
  - no_offer: no tile is staged or scanned; nothing then reads the
    accumulators, so ptxas drops the product too: the loads and barriers.
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
from fedrann_tpu_torch.knn.topk import normalize_rows

HOOKS = {
    # the counts of merges and survivors (full)
    "#include \"common.cuh\"\n": (
        "#include \"common.cuh\"\n"
        "__device__ unsigned long long g_counts[2];\n"
        "extern \"C\" int bd_counts(unsigned long long* out, int reset) {\n"
        "  unsigned long long z[2] = {0, 0};\n"
        "  return reset ? (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z))\n"
        "               : (int)cudaMemcpyFromSymbol(out, g_counts,\n"
        "                                           sizeof(z));\n"
        "}\n"),
    "  int64_t* S = rs.sv + r * SV;\n": (
        "  int64_t* S = rs.sv + r * SV;\n#ifdef BD_COUNT\n"
        "  if (lane == 0) { atomicAdd(&g_counts[0], 1ull);\n"
        "    atomicAdd(&g_counts[1], (unsigned long long)rs.cnt[r]); }\n"
        "#endif\n"),
    "      offer_half(rs, sc, half, row0, m, col0, n, first, ids);\n": (
        "#ifndef BD_NO_SCAN\n"
        "      offer_half(rs, sc, half, row0, m, col0, n, first, ids);\n"
        "#endif\n"),
    "    if ((step + 1) % kt_n != 0) continue;\n": (
        "    if ((step + 1) % kt_n != 0) continue;\n#ifdef BD_NO_OFFER\n"
        "    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;\n    continue;\n"
        "#endif\n"),
}
VARIANTS = {"full": ["-DBD_COUNT"], "no_scan": ["-DBD_NO_SCAN"],
            "no_offer": ["-DBD_NO_OFFER"]}
SHAPES = ((15000, 15000), (2048, 65536), (65536, 65536))


def build(out_dir: str) -> dict:
    csrc = str(_build._CSRC)
    with open(os.path.join(csrc, "knn_merge.cu")) as f:
        src = f.read()
    for old, new in HOOKS.items():
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
        for name, flags in VARIANTS.items()}
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k4_breakdown: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    libs = build(os.path.join(_build.BUILD_DIR, "breakdown"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = normalize_rows(torch.randn((65536, 512), device=dev,
                                      generator=gen)).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        for m, n in SHAPES:
            q, c = rows[:m], rows[:n]
            out = torch.empty((m, 50), dtype=torch.int64, device=dev)

            def call(lib=lib, q=q, c=c, m=m, n=n, out=out):
                rc = lib.fk_knn_merge(q.data_ptr(), m, c.data_ptr(), n, 512,
                                      1, 0, 0, None, None, 0, 50,
                                      out.data_ptr(), 1, stream)
                if rc:
                    sys.exit(f"k4_breakdown: {name} launch failed ({rc})")

            ms = time_ms(call)
            text = (f"{name} {m} x {n} x 512, k = 50: {ms:.3f} ms = "
                    f"{2 * m * n * 512 / ms / 1e9:.1f} TFLOP/s")
            if name == "full":
                counts = (ctypes.c_ulonglong * 2)()
                lib.bd_counts(counts, 1)
                call()
                torch.cuda.synchronize()
                lib.bd_counts(counts, 0)
                text += (f"; {counts[0] / m:.1f} merges and "
                         f"{counts[1] / m:.1f} survivors a row")
            print(text, flush=True)


if __name__ == "__main__":
    main()
