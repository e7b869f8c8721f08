#!/usr/bin/env python3
"""K8 and K9 rebuilt in variants and timed side by side on one card:

    python3 tools/k8_k9_variants.py [--parent DIR]

Each variant is a copy of the repository's source (csrc/srp_signs.cu,
csrc/ivf_segment_sum.cu) with one constant or one line changed, built by
its own nvcc into a temporary directory and loaded with ctypes. With
--parent, the same two sources of the checkout DIR (an earlier commit
unpacked by `git archive`) are built beside them as "parent K8" and
"parent K9": K9 there takes the sorted ids and bounds of _segments' torch
sort, which its timed call includes. Every variant is held bitwise
against the plain version (paired_table_plain, segment_sum_plain), then
timed by CUDA events, in turns: each variant, then each again in reverse
order.

- K8 at phase 4's library size (L = 309,830 random counts, d = 512),
  float32 and bfloat16: the source (bands of 8 rows, 4 KB of a row a
  block), bands of 4 and 16, 2 KB of a row a block, the xor-shifts'
  high-word shift on the FMA
  pipe (__umulhi), and each field hashed alone (no step shared by a
  vector's entries); the store floor beside them (fill_ of a table of the
  same shape and dtype: no call computes the table).
- K9's whole call (its bucketing included) on chip_smoke.py's 262,144 x
  512 read-overlap rows at C = 1,024 and on 15,000 x 512 random unit rows
  at C = 256, each with the assignments of its own k-means, float32 and
  bfloat16 rows: RING (member rows a lane keeps in flight) 8, 16 (the
  source), 24, and 32 at 2 warps a block; the count by __match_any_sync
  groups (one atomic a group, not a row); the scatter's equal ids found
  by ballots over their bits instead of __match_any_sync; 256 and 512
  tiles (the source plans up to 1,024); index_add_ of the same rows
  beside them, and each variant's device us by kernel (float32).

Prints each variant's registers (ptxas -v) and the opcode counts of the
source's K8 kernels (cuobjdump -sass): a thread's instructions and their
share an entry (4 float32 or 8 bfloat16 a row of its band), also of a
build of the shared path alone (the path nearly every vector takes;
counted, not run). Exits non-zero without a card or where a variant
differs from the plain version.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "fedrann_tpu_torch", "csrc")
SOURCES = {"K8": "srp_signs.cu", "K9": "ivf_segment_sum.cu"}
# K9 variants with fewer tiles a bucketing than the source's
# (ivf.K9_MAX_TILES), planned by ivf.k9_tiles(n, c, tiles)
K9_TILES = (256, 512)
# the C entry of K9 before its own bucketing: rows, d, is_bf16, order
# (int64), bounds (int64), n_clusters, accumulate, out, stream
PARENT_K9 = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def changed(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"k8_k9_variants: {old!r} not once in a source")
    return text.replace(old, new)


def variants(parent: str | None) -> dict:
    """name -> (entry, source text) of every variant."""
    text = {}
    for kernel, name in SOURCES.items():
        with open(os.path.join(CSRC, name)) as f:
            text[kernel] = f.read()
    k8, k9 = text["K8"], text["K9"]
    out = {"K8": ("fk_srp_paired", k8)}
    for band in (4, 16):
        out[f"K8 band {band}"] = ("fk_srp_paired", changed(
            k8, "constexpr int PAIRED_BAND = 8;",
            f"constexpr int PAIRED_BAND = {band};"))
    out["K8 2 KB of a row a block"] = ("fk_srp_paired", changed(
        k8, "constexpr int PAIRED_THREADS = 256;",
        "constexpr int PAIRED_THREADS = 128;"))
    out["K8 shift on FMA"] = ("fk_srp_paired", changed(
        k8, "  hi ^= hi >> S;\n", "  hi ^= __umulhi(hi, 1u << (32 - S));\n"))
    shared = "  if ((lo0 & 0x3FFFFFFFu) <= 0x40000000u - V) {\n"
    out["K8 each field alone"] = ("fk_srp_paired", changed(
        k8, shared, "  if (false) {\n"))
    # counted, not run: the shared path alone, as nearly every vector takes it
    out["SASS of K8's shared path"] = ("fk_srp_paired", changed(
        k8, shared, "  if (true) {\n"))
    ring = re.search(r"constexpr int RING = (\d+);", k9)
    for n in (8, 16, 24):
        name = "K9" if str(n) == ring.group(1) else f"K9 RING {n}"
        out[name] = ("fk_ivf_segment_sum", changed(
            k9, ring.group(0), f"constexpr int RING = {n};"))
    out["K9 RING 32, 2 warps"] = ("fk_ivf_segment_sum", changed(changed(
        k9, ring.group(0), "constexpr int RING = 32;"),
        "constexpr int SUM_WARPS = 4;", "constexpr int SUM_WARPS = 2;"))
    out["K9 count by __match_any_sync"] = ("fk_ivf_segment_sum", changed(
        k9, "      if (cs[k] >= 0) atomicAdd(hist + cs[k], 1);\n",
        "      const unsigned peers = __match_any_sync(FULL, cs[k]);\n"
        "      if (cs[k] >= 0 && lane == __ffs(peers) - 1) {\n"
        "        atomicAdd(hist + cs[k], __popc(peers));\n      }\n"))
    out["K9 ballot peers"] = ("fk_ivf_segment_sum", changed(
        k9, "      const unsigned peers = __match_any_sync(FULL, c);\n",
        "      const unsigned v = c + 1;\n      unsigned peers = FULL;\n"
        "      for (int b = 0; b < 32 - __clz(c_n); ++b) {\n"
        "        const unsigned x = __ballot_sync(FULL, (v >> b) & 1);\n"
        "        peers &= ((v >> b) & 1) ? x : ~x;\n      }\n"))
    for tiles in K9_TILES:
        out[f"K9 {tiles} tiles"] = ("fk_ivf_segment_sum", k9)
    if parent:
        for kernel, name in SOURCES.items():
            src = os.path.join(parent, "fedrann_tpu_torch", "csrc", name)
            with open(src) as f:
                out[f"parent {kernel}"] = (out[kernel][0], f.read())
    return out


def build(tmp: str, table: dict) -> dict:
    """name -> the loaded entry of each variant, all nvcc runs at once."""
    from fedrann_tpu_torch import _build

    procs = {}
    for i, (name, (_, text)) in enumerate(table.items()):
        src = os.path.join(tmp, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (src[:-3] + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             src[:-3] + ".so", src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k8_k9_variants: {name} failed:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"{name}: registers {regs}")
        if name.startswith("SASS"):
            sass_counts(so, name)
            continue
        entry = table[name][0]
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = (PARENT_K9 if name == "parent K9"
                       else _build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
        entries[name] = fn
        if name in ("K8", "parent K8", "K8 each field alone"):
            sass_counts(so, name)
    return entries


# opcodes of the integer pipe (the ALU) in K8's SASS; IMAD goes to the
# FMA pipe
ALU_OPS = ("LOP3", "SHF", "ISETP", "SEL", "IADD3", "LEA", "PRMT", "VIADD")


def sass_counts(so: str, label: str) -> None:
    """The opcode counts of each K8 kernel instance in the library `so`:
    the instance's instructions (a thread's code: its set-up, the row loop
    and the stores) over the entries a thread writes a row (4 float32, 8
    bfloat16), and the row loop's own (the instructions from the target
    of its backward branch to the branch: what a thread runs a row) an
    entry, in all and on the integer pipe."""
    from fedrann_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        title = fn.split("\n", 1)[0]
        if "srp_paired_kernel" not in title:
            continue
        code = [(int(at, 16), op.split(".")[0], rest) for at, op, rest in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z0-9_.]+)([^;\n]*);", fn)]
        ops = collections.Counter(op for _, op, _ in code)
        flags = re.search(r"ILb(\d)E(?:Lb(\d)E)?", title)
        bf16 = flags is not None and flags.group(1) == "1"
        vec = "" if flags is None or flags.group(2) is None \
            else (" vec" if flags.group(2) == "1" else " scalar stores")
        per = 8 if bf16 else 4
        loops = [(int(m.group(1), 16), at) for at, op, rest in code
                 if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", rest))
                 and int(m.group(1), 16) < at]
        text = (f"{label} {'bf16' if bf16 else 'f32'}{vec} SASS: "
                f"{sum(ops.values())} instructions, "
                f"{sum(ops.values()) / per:.1f} an entry")
        if loops:
            lo, hi = max(loops, key=lambda r: r[1] - r[0])
            body = collections.Counter(op for at, op, _ in code
                                       if lo <= at <= hi)
            alu = sum(body[op] for op in ALU_OPS)
            text += (f"; the row loop {sum(body.values())} ("
                     f"{sum(body.values()) / per:.1f} an entry, "
                     f"{alu / per:.1f} on the integer pipe, "
                     f"{body['IMAD'] / per:.1f} IMAD)")
        print(f"{text}; {dict(ops.most_common(10))}", flush=True)


def time_ms(fn, reps: int = 20) -> float:
    import torch

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


def in_turns(runs: dict) -> dict:
    """name -> [ms, ms]: each run timed, then each again in reverse."""
    out = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            out[name].append(round(time_ms(runs[name]), 4))
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"k8_k9_variants: {what} differs from its plain "
                         "version")


def k8(entries: dict, dev, card: str) -> None:
    import numpy as np
    import torch

    from fedrann_tpu_torch.project import srp

    lib_size, d = 309_830, 512
    counts = torch.from_numpy(np.random.default_rng(1).integers(
        2, 50, lib_size)).to(dev)
    icf, dens, mix, scale = srp._stream(counts, d, 602, None)
    mags = (icf[:lib_size] * scale).contiguous()
    for dtype, view in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        want = srp.paired_table_plain(icf, d, mix, dens, scale, dtype)
        runs = {}
        for name, fn in entries.items():
            if "K8" not in name:
                continue
            out = torch.empty_like(want)

            def run(fn=fn, out=out):
                fn(int(mix) & ((1 << 64) - 1), lib_size, d,
                   srp._sign_bound(dens), mags.data_ptr(),
                   int(dtype == torch.bfloat16), out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)

            run()
            torch.cuda.synchronize()
            check(torch.equal(out.view(view), want.view(view)),
                  f"{name} {dtype}")
            runs[name] = run
        floor = torch.empty_like(want)
        runs["store floor (fill_)"] = lambda: floor.fill_(0)
        print(f"K8 at L = {lib_size}, d = {d}, {dtype}: ms {in_turns(runs)}"
              f" [{card}]", flush=True)
        del want, runs, floor


def k9(entries: dict, cs, dev, card: str) -> None:
    import torch

    from fedrann_tpu_torch.knn import ivf

    cases = (("11b's rows", cs.overlap_rows(cs.IVF_ROWS, dev), 1024),
             ("15,000 random unit rows", torch.nn.functional.normalize(
                 torch.randn(15000, 512, device=dev,
                             generator=torch.Generator(dev).manual_seed(
                                 602)), dim=1), 256))
    for label, x, c in cases:
        en = ivf._unit_padded(x, "bf16")[: x.shape[0]]
        a = ivf._top_clusters(en, ivf._kmeans(en, c, 3), 1)[:, 0]
        n = a.shape[0]
        plans = {}
        for tiles in (ivf.K9_MAX_TILES, *K9_TILES):
            tile, n_tiles = ivf.k9_tiles(n, c, tiles)
            plans[tiles] = (tile, n_tiles, torch.empty(
                n_tiles * c + n + 2 * c + 2, dtype=torch.int32, device=dev))
        sizes = torch.bincount(a, minlength=c)
        for dtype in (torch.float32, torch.bfloat16):
            rows = en.to(dtype).contiguous()
            want = ivf.segment_sum_plain(rows, a, c)
            runs = {}
            for name, fn in entries.items():
                if "K9" not in name:
                    continue
                out = torch.empty((c, 512), device=dev)
                if name == "parent K9":
                    def run(fn=fn, out=out):
                        order, bounds = ivf._segments(a, c)
                        fn(rows.data_ptr(), 512,
                           int(dtype == torch.bfloat16), order.data_ptr(),
                           bounds.data_ptr(), c, 0, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
                else:
                    tiles = next((t for t in K9_TILES
                                  if name == f"K9 {t} tiles"),
                                 ivf.K9_MAX_TILES)
                    tile, n_tiles, scratch = plans[tiles]

                    def run(fn=fn, out=out, tile=tile, n_tiles=n_tiles,
                            scratch=scratch):
                        fn(rows.data_ptr(), n, 512,
                           int(dtype == torch.bfloat16), a.data_ptr(), c,
                           tile, n_tiles, scratch.data_ptr(), 0,
                           out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)

                run()
                torch.cuda.synchronize()
                check(torch.equal(out.view(torch.int32),
                                  want.view(torch.int32)), f"{name} {dtype}")
                runs[name] = run
                if dtype == torch.float32:
                    print(f"{name} at {label}: device "
                          f"{cs.device_us(run, 5, True)} us a call",
                          flush=True)
            runs["index_add_"] = lambda: torch.zeros(
                (c, 512), device=dev).index_add_(0, a, rows.float())
            print(f"K9 whole call at {label} x 512, C = {c} (largest "
                  f"cluster {int(sizes.max())}), {dtype} rows: ms "
                  f"{in_turns(runs)} [{card}]", flush=True)


def main() -> None:
    import importlib.util

    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k8_k9_variants: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp, variants(args.parent))
        k8(entries, dev, card)
        k9(entries, cs, dev, card)


if __name__ == "__main__":
    main()
