#!/usr/bin/env python3
"""chip_smoke.py phase 8b's out-of-core exact search on one card, with its
result wire timed apart:

    python3 tools/ooc_split.py [--port DIR] [--runs N]

Makes 8b's OOC_ROWS x 512 rows of rank 16 plus noise (chip_smoke's
rank16_rows, FLAGS' --seed) and runs knn_exact_ooc on them N times (k =
50, OOC_BUDGET bytes, the f32 wire) in this one process, the first the
process's first search (its page-locked blocks and the kernels' first
launches cold). Logs each run's seconds and, within it, the seconds of
its keys_to_host calls (each timed on the host clock from a synchronize
before it to its return: the decode of DECODE_ROWS query rows at a time
into the host arrays), and a digest of the indices and distances, which
must be the same in every run (and in another checkout's, where the
search is meant to be unchanged). With --port, the fedrann_tpu_torch
package of the checkout DIR is timed (an earlier commit unpacked by `git
archive`); this checkout's chip_smoke.py drives it. Exits non-zero where
no card is visible or two runs disagree.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", default=HERE)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    import importlib.util

    import torch

    sys.path.insert(0, os.path.abspath(args.port))  # its fedrann_tpu_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.knn import ooc

    card = f"{torch.cuda.get_device_name(0)}, {args.port}"
    dev = torch.device("cuda")
    _build.build()
    _build.kernels()
    emb, _ = cs.rank16_rows(cs.OOC_ROWS, 512)
    wire = {"secs": 0.0, "calls": 0}
    decode = ooc.keys_to_host

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*a, **kw)
        wire["secs"] += time.perf_counter() - t0
        wire["calls"] += 1
        return out

    ooc.keys_to_host = timed
    digests = set()
    for run in range(args.runs):
        wire.update(secs=0.0, calls=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx, dist = ooc.knn_exact_ooc(emb, 50, cs.OOC_BUDGET,
                                      transfer="f32", device=dev)
        secs = time.perf_counter() - t0
        digest = hashlib.sha256(idx.tobytes() + dist.tobytes()).hexdigest()
        digests.add(digest)
        cs.log(f"8b run {run + 1} of {args.runs}"
               f"{' (the process first)' if run == 0 else ''}: "
               f"knn_exact_ooc {secs:.4f} s on {cs.OOC_ROWS} x 512 rows, of "
               f"which keys_to_host {wire['secs']:.4f} s in {wire['calls']} "
               f"calls; result {digest[:16]} [{card}]")
    if len(digests) != 1:
        cs.fail(f"8b: {len(digests)} different results in {args.runs} runs")


if __name__ == "__main__":
    main()
