#!/usr/bin/env python3
"""K8 and K9 rebuilt in variants and timed side by side on one card:

    python3 tools/k8_k9_variants.py

Each variant is a copy of the repository's source (csrc/srp_signs.cu,
csrc/ivf_segment_sum.cu) with one constant or one store changed, built by
its own nvcc into a temporary directory and loaded with ctypes. Every
variant is held bitwise against the plain version (paired_table_plain,
segment_sum_plain), then timed by CUDA events over kernel launches alone
(K9's sort and bounds made once), in turns: each variant, then each again
in reverse order.

- K8 at phase 4's library size (L = 309,830 random counts, d = 512), float32
  and bfloat16: the source (256 threads a block), 128 threads, and
  streaming stores (__stcs).
- K9 on chip_smoke.py's 262,144 x 512 read-overlap rows at C = 1,024 and on
  15,000 x 512 random unit rows at C = 256, each with the assignments of its
  own k-means, float32 and bfloat16 rows: AHEAD (member rows a lane loads
  before adding) 2, 4 (the source), 8 and 16, and 256 threads a block;
  index_add_ of the same rows beside it.

Prints each variant's registers (ptxas -v) and the opcode counts of the
source's K8 kernels (cuobjdump -sass). Exits non-zero without a card or
where a variant differs from the plain version.
"""

from __future__ import annotations

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


def variants() -> dict:
    """name -> (entry, source text) of every variant."""
    with open(os.path.join(CSRC, "srp_signs.cu")) as f:
        k8 = f.read()
    with open(os.path.join(CSRC, "ivf_segment_sum.cu")) as f:
        k9 = f.read()

    def changed(text: str, old: str, new: str) -> str:
        if text.count(old) != 1:
            raise SystemExit(f"k8_k9_variants: {old!r} not once in a source")
        return text.replace(old, new)

    out = {"K8": ("fk_srp_paired", k8),
           "K8 128 threads": ("fk_srp_paired", changed(
               k8, "constexpr int THREADS = 256;",
               "constexpr int THREADS = 128;")),
           "K8 __stcs": ("fk_srp_paired", changed(changed(
               k8, "*reinterpret_cast<float4*>(dst) = make_float4(v[0], "
               "v[1], v[2], v[3]);", "__stcs(reinterpret_cast<float4*>(dst)"
               ", make_float4(v[0], v[1], v[2], v[3]));"),
               "*reinterpret_cast<uint4*>(dst) = w;",
               "__stcs(reinterpret_cast<uint4*>(dst), w);"))}
    ahead = re.search(r"constexpr int AHEAD = (\d+);", k9)
    for n in (2, 4, 8, 16):
        name = "K9" if str(n) == ahead.group(1) else f"K9 AHEAD {n}"
        out[name] = ("fk_ivf_segment_sum", changed(
            k9, ahead.group(0), f"constexpr int AHEAD = {n};"))
    out["K9 256 threads"] = ("fk_ivf_segment_sum", changed(
        k9, "constexpr int THREADS = 128;", "constexpr int THREADS = 256;"))
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
        entry = table[name][0]
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        entries[name] = fn
        if name == "K8":
            sass_counts(so)
    return entries


def sass_counts(so: str) -> None:
    """The opcode counts of each K8 kernel instance in the library `so`."""
    from fedrann_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        title = fn.split("\n", 1)[0]
        if "srp_paired_kernel" not in title:
            continue
        ops = collections.Counter(m.split(".")[0] for m in re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", fn))
        form = "bf16" if "ILb1E" in title else "f32"
        print(f"K8 {form} SASS: {sum(ops.values())} instructions, "
              f"{dict(ops.most_common(8))}")


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
            if not name.startswith("K8"):
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
        print(f"K8 at L = {lib_size}, d = {d}, {dtype}: ms {in_turns(runs)}"
              f" [{card}]", flush=True)
        del want, runs


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
        order, bounds = ivf._segments(a, c)
        sizes = bounds[1:] - bounds[:-1]
        for dtype in (torch.float32, torch.bfloat16):
            rows = en.to(dtype).contiguous()
            want = ivf.segment_sum_plain(rows, a, c)
            runs = {}
            for name, fn in entries.items():
                if not name.startswith("K9"):
                    continue
                out = torch.empty((c, 512), device=dev)

                def run(fn=fn, out=out):
                    fn(rows.data_ptr(), 512, int(dtype == torch.bfloat16),
                       order.data_ptr(), bounds.data_ptr(), c, 0,
                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)

                run()
                torch.cuda.synchronize()
                check(torch.equal(out.view(torch.int32),
                                  want.view(torch.int32)), f"{name} {dtype}")
                runs[name] = run
            runs["index_add_"] = lambda: torch.zeros(
                (c, 512), device=dev).index_add_(0, a, rows.float())
            print(f"K9 at {label} x 512, C = {c} (largest cluster "
                  f"{int(sizes.max())}), {dtype} rows: ms {in_turns(runs)}; "
                  f"the sort and bounds "
                  f"{time_ms(lambda: ivf._segments(a, c)):.4f} ms "
                  f"[{card}]", flush=True)


def main() -> None:
    import importlib.util

    import torch

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
        entries = build(tmp, variants())
        k8(entries, dev, card)
        k9(entries, cs, dev, card)


if __name__ == "__main__":
    main()
