#!/usr/bin/env python3
"""K11 rebuilt in variants and timed side by side on one card:

    python3 tools/k11_variants.py

Each variant is a copy of csrc/ivf_segment_sum.cu with one line changed,
built by its own nvcc (all at once) into a temporary directory and loaded
with ctypes; its fk_ivf_bucket runs on 11b's member lists (spill 2,
524,288 ids) and probe lists (p = 8, 2,097,152 ids) over C = 1,024, made by
knn_ivf's own k-means on chip_smoke.py's 262,144 x 512 read-overlap rows
(FLAGS' --seed). Each call is timed behind a busy card
(chip_smoke.behind_busy_card: its device us by CUDA events, its host us),
every variant in turn, then again in reverse order:
  - source: as shipped, held bitwise to bucket_clusters_plain;
  - stores at r: every entry written at its own index instead of its
    bucket position (the positions still made; coalesced stores; timing
    only, its output is not the buckets);
  - no stores: the positions made, no entry written (timing only);
  - no walks: neither walk of the ids, the rest as the source (the
    barriers, the scans, the bounds and the units; timing only);
  - count walk alone: the scatter's walk skipped (timing only);
  - 8 and 32 entries a cluster a tile: BK_RUN, the tiles the plan aims
    at (more, shorter tiles or fewer, longer ones; bitwise);
  - no tile floor: BK_MIN_TILES 1 (bitwise);
  - BATCH 16: 16 steps' ids a load (bitwise).
torch.sort(stable=True) of the same ids beside them. The card's name and power limit head the output. Exits
non-zero without a card or where a bitwise variant differs.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
SOURCE = os.path.join(HERE, "fedrann_tpu_torch", "csrc", "ivf_segment_sum.cu")
STORE = "                 k.vals[pos] = pow2 ? q >> shift : q / k.div;\n"


def changed(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"k11_variants: {old!r} not once in the source")
    return text.replace(old, new)


def variants() -> dict:
    """name -> (source text, bitwise or timing only)."""
    with open(SOURCE) as f:
        text = f.read()
    out = {"source": (text, True)}
    out["stores at r"] = (changed(
        text, "const int64_t pos = at + (k.smem ? 0 : k.bounds[c])\n"
        "                                     + __popc(peers & below);\n",
        "const int64_t pos = r + 0 * (at + (k.smem ? 0 : k.bounds[c])\n"
        "                                     + __popc(peers & below));\n"),
        False)
    out["no stores"] = (changed(changed(text, STORE,
                                        "                 if (pos < 0) "
                                        + STORE.lstrip()),
                                "                 if (k.slots != nullptr) "
                                "{\n",
                                "                 if (pos < 0) {\n"), False)
    count_walk = ("  if (walks) {\n    walk_ids(k.a, r0, end, c_n, "
                  "k.nbits,\n             [&](int64_t, int c,")
    scatter_walk = ("  if (walks) {\n    walk_ids(k.a, r0, end, c_n, "
                    "k.nbits,\n             [&](int64_t r, int c,")
    out["no walks"] = (changed(changed(
        text, count_walk, count_walk.replace("(walks)", "(false)")),
        scatter_walk, scatter_walk.replace("(walks)", "(false)")), False)
    out["count walk alone"] = (changed(
        text, scatter_walk, scatter_walk.replace("(walks)", "(false)")),
        False)
    for run in (8, 32):
        out[f"{run} entries a cluster a tile"] = (changed(
            text, "constexpr int BK_RUN = 16;",
            f"constexpr int BK_RUN = {run};"), True)
    out["no tile floor"] = (changed(
        text, "constexpr int BK_MIN_TILES = 128;",
        "constexpr int BK_MIN_TILES = 1;"), True)
    out["BATCH 16"] = (changed(
        text, "constexpr int BATCH = 8;", "constexpr int BATCH = 16;"), True)
    return out


def build(tmp: str, table: dict) -> dict:
    """name -> the loaded library of each variant, all nvcc runs at once."""
    from fedrann_tpu_torch import _build

    procs = {}
    for i, (name, (text, _)) in enumerate(table.items()):
        src = os.path.join(tmp, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (src[:-3] + ".so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", src[:-3] + ".so",
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k11_variants: {name} failed:\n{log}")
        lib = ctypes.CDLL(so)
        lib.fk_ivf_bucket.argtypes = _build._SIGNATURES["fk_ivf_bucket"]
        lib.fk_ivf_bucket.restype = ctypes.c_int
        libs[name] = lib
        print(f"{name}: registers of the file's kernels "
              f"{re.findall(r'Used (\d+) registers', log)}", flush=True)
    return libs


def main() -> None:
    import torch

    import chip_smoke as cs
    from fedrann_tpu_torch.knn import ivf

    if not torch.cuda.is_available():
        sys.exit("k11_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(f"card: {card}", flush=True)
    table = variants()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, table)
        dev = torch.device("cuda")
        c = 1024
        en = ivf._unit_padded(cs.overlap_rows(cs.IVF_ROWS, dev), "bf16")
        _, top = ivf._tables(en[: cs.IVF_ROWS], c, 3, 2, 8)
        del en
        members = top[:, :2].reshape(-1).contiguous()
        want_m = ivf.bucket_clusters_plain(members, c, 2)
        sides = {"member side (spill 2)": (members, 2, None, want_m),
                 "probe side (p = 8)": (
                     top[:, :8].reshape(-1).contiguous(), 8, want_m.bounds,
                     None)}
        stream = torch.cuda.current_stream().cuda_stream
        for label, (ids, div, mb, want) in sides.items():
            n = ids.numel()
            if want is None:
                want = ivf.bucket_clusters_plain(ids, c, div, mb)
            grid = ivf.k6_grid(n, c) if mb is not None else 0
            scratch = ivf.k11_scratch(c)
            out = torch.empty(4 * grid + 2 * n + c + 2 + scratch,
                              dtype=torch.int32, device=dev)
            at = [0, 4 * grid, 4 * grid + n, 4 * grid + 2 * n,
                  4 * grid + 2 * n + c + 1, 4 * grid + 2 * n + c + 2]
            ptr = [out.data_ptr() + 4 * i for i in at]
            runs = {}
            for name, lib in libs.items():
                def run(lib=lib, name=name):
                    rc = lib.fk_ivf_bucket(
                        ids.data_ptr(), n, c, div,
                        None if mb is None else mb.data_ptr(), ptr[1],
                        ptr[2] if mb is not None else None, ptr[3],
                        ptr[0] if mb is not None else None,
                        ptr[4] if mb is not None else None, ptr[5], scratch,
                        stream)
                    if rc:
                        raise SystemExit(f"k11_variants: {name} failed ({rc})")
                runs[name] = run
                if table[name][1]:
                    run()
                    got = ivf.Buckets(out[at[1] : at[2]], out[at[3] : at[4]],
                                      out[at[2] : at[3]] if mb is not None
                                      else None)
                    if not (torch.equal(got.vals, want.vals)
                            and torch.equal(got.bounds, want.bounds)
                            and (mb is None
                                 or torch.equal(got.slots, want.slots))):
                        raise SystemExit(f"k11_variants: {name} differs "
                                         "from bucket_clusters_plain")
            runs["torch.sort(stable=True)"] = lambda: torch.sort(
                ids, stable=True)
            times = {name: [] for name in runs}
            for order in (list(runs), list(runs)[::-1]):
                for name in order:
                    times[name].append(cs.behind_busy_card(runs[name], 15))
            print(f"{label}, {n} ids, C = {c} (device us by events / host "
                  "us, behind a busy card; two turns): " + "; ".join(
                      f"{name} " + ", ".join(f"{d:.1f} / {h:.1f}"
                                             for h, d in t)
                      for name, t in times.items()) + f" [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
