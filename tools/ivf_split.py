#!/usr/bin/env python3
"""chip_smoke.py phase 11b's knn_ivf, split by step, on one card:

    python3 tools/ivf_split.py [--port DIR]

Makes 11b's 262,144 x 512 read-overlap rows on the card (chip_smoke's
overlap_rows, FLAGS' --seed), times knn_exact and knn_ivf (k = 50) cold
and warm and logs the warm result's digest (its indices' and distances'
bytes) and its recall against knn_exact on the 2,048 sampled queries.
Then one more knn_ivf inside chip_smoke's ivf_step_split (each step
between synchronizes: the k-means assignment, the segment sums, the
spill/probe ranking, the member and probe sides, the rescore, the merge,
keys_to_host) with the launches of the port's kernels, and the rescore
step cut into its parts (rescore_setup: the probe side, the bounds'
page-locked copy, the rows' bfloat16 copy, K6, K7, the wait for the
copy, the plan's statistics), each between synchronizes with its host
ms (the call's own) and event ms beside the whole step's. The card's
name and power limit head the output. With --port DIR, the
fedrann_tpu_torch package of the checkout DIR (another commit unpacked
by `git archive`) is timed through knn_ivf alone, driven by this
checkout's chip_smoke.py, and no split is made: the split reads this
package's own steps. Exits non-zero where no card is visible.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rescore_setup(cs, ivf, rows, card: str) -> None:
    """11b's rescore step (C = 1,024, p = 8, spill 2, k = IVF_K, bf16) on
    the members and probes of its own k-means, whole and cut into its
    parts, each part between synchronizes: (event ms, host ms of the call
    alone, host ms to its synchronize)."""
    import numpy as np
    import torch

    from fedrann_tpu_torch import _build

    n, c, p, spill, k = rows.shape[0], 1024, 8, 2, cs.IVF_K
    dev = rows.device
    en_pad = ivf._unit_padded(rows, "bf16")
    _, top = ivf._tables(en_pad[:n], c, 3, spill, p)
    probes = top[:, :p].contiguous()
    flat = probes.reshape(-1)
    members = ivf._member_side(top[:, :spill].reshape(-1), c, spill)
    parts: dict = {}

    def part(name, fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        parts[name] = (start.elapsed_time(end), host * 1e3,
                       (time.perf_counter() - t0) * 1e3)
        return out

    def whole():
        return ivf._rescore(en_pad, n, members, 0, n, probes, k, spill,
                            "bf16", {})()

    whole()
    for turn in (1, 2):
        keys = part(f"the whole rescore step ({turn})", whole)
    queries = part("probe side (K11)", lambda: ivf.bucket_clusters(
        flat, c, p, members.bounds))

    def bounds_copy():
        host = [torch.empty(b.shape, dtype=torch.int32, pin_memory=True)
                for b in (members.bounds, queries.bounds)]
        for h, b in zip(host, (members.bounds, queries.bounds)):
            h.copy_(b, non_blocking=True)
        return host, torch.cuda.current_stream().record_event()

    host, copied = part("the bounds to page-locked memory (enqueued)",
                        bounds_copy)
    rows16 = part("the bf16 rows (_tma_rows)",
                  lambda: ivf._tma_rows(en_pad, torch.bfloat16))
    buf = torch.empty((n, p, k), dtype=torch.int64, device=dev)
    part("K6", lambda: _build.launch(
        "fk_ivf_rescore", rows16.data_ptr(), rows16.shape[1], 1,
        members.vals.data_ptr(), queries.vals.data_ptr(),
        queries.slots.data_ptr(), queries.units.data_ptr(),
        queries.n_units.data_ptr(), queries.units.shape[0], 0, n, p, k,
        buf.data_ptr(), device=dev))
    got = part("K7", lambda: ivf.merge_probe_lists(buf, k, spill))
    counts_h, qcounts_h = part(
        "the wait for the copy", lambda: copied.synchronize() or [
            np.diff(h.numpy()).astype(np.int64) for h in host])
    part("the plan and its statistics (_add_plan)",
         lambda: ivf._add_plan({}, counts_h, qcounts_h))
    if not torch.equal(got, keys):
        cs.fail("rescore_setup: the parts' keys differ from the step's")
    cs.log("11b rescore step by part (event ms / host ms of the call / host "
           "ms to its synchronize): " + "; ".join(
               f"{name} {e:.3f} / {h:.3f} / {t:.3f}"
               for name, (e, h, t) in parts.items()) + f" [{card}]")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", default=HERE)
    args = parser.parse_args()
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(args.port))  # its fedrann_tpu_torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from fedrann_tpu_torch import _build
    from fedrann_tpu_torch.knn import ivf, topk
    from fedrann_tpu_torch.knn.topk import knn_exact, merge_block

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = f"{smi.stdout.strip().splitlines()[0]}, {args.port}"
    dev = torch.device("cuda")
    _build.build()
    _build.kernels()
    rows = cs.overlap_rows(cs.IVF_ROWS, dev)
    (ref, _), exact_secs, _ = cs.measured(
        lambda: knn_exact(rows, cs.IVF_K, transfer="f32"), [dev])
    _, cold, _ = cs.measured(lambda: ivf.knn_ivf(rows, cs.IVF_K,
                                                 transfer="f32"), [dev])
    (idx, dist), warm, _ = cs.measured(lambda: ivf.knn_ivf(
        rows, cs.IVF_K, transfer="f32"), [dev])
    digest = hashlib.sha256(np.ascontiguousarray(idx).tobytes()
                            + np.ascontiguousarray(dist).tobytes()
                            ).hexdigest()[:16]
    rng = np.random.default_rng(int(cs.FLAGS[cs.FLAGS.index("--seed") + 1]))
    sample = np.sort(rng.choice(cs.IVF_ROWS, cs.IVF_SAMPLE, replace=False))
    last = ivf.knn_ivf.last
    cs.log(f"11b run: knn_ivf {warm:.4f} s warm, {cold:.4f} s cold; "
           f"knn_exact {exact_secs:.4f} s; C = {last['clusters']}, largest "
           f"cluster {last['max_members']}, {last['pair_scores']:.4g} "
           f"padded pair-scores; recall "
           f"{cs.sample_recall(idx, ref, sample):.5f} on {cs.IVF_SAMPLE} "
           f"queries; warm result digest {digest} [{card}]")
    if os.path.abspath(args.port) != HERE:
        return
    kernels = {"K4": merge_block, "K6": ivf.rescore_clusters,
               "K7": ivf.merge_probe_lists, "K9": ivf.segment_sum_rows,
               "K10": topk.result_wire, "K11": ivf.bucket_clusters}
    counts = {name: fn.kernel_launches for name, fn in kernels.items()}
    with cs.ivf_step_split() as split:
        _, secs, _ = cs.measured(lambda: ivf.knn_ivf(
            rows, cs.IVF_K, transfer="f32"), [dev])
    launches = {k: fn.kernel_launches - counts[k]
                for k, fn in kernels.items()}
    cs.log(f"11b split run: knn_ivf {secs:.4f} s, "
           f"{ivf.knn_ivf.last['real_pair_scores']:.4g} real pair-scores; "
           f"launches {launches} [{card}]")
    cs.log_ivf_split("11b knn_ivf", split, secs * 1e3, card)
    rescore_setup(cs, ivf, rows, card)


if __name__ == "__main__":
    main()
