#!/usr/bin/env python3
"""chip_smoke.py phase 11b's knn_ivf, split by step, on one card:

    python3 tools/ivf_split.py [--port DIR]

Makes 11b's 262,144 x 512 read-overlap rows on the card (chip_smoke's
overlap_rows, FLAGS' --seed), times knn_exact and knn_ivf (k = 50) cold
and warm, then one more knn_ivf inside chip_smoke's ivf_step_split (each
step between synchronizes: the k-means assignment, the segment sums, the
spill/probe ranking, the member and probe tables, the rescore, the merge,
keys_to_host) and logs the split, the recall against knn_exact on the
2,048 sampled queries and the launches of the port's kernels. With
--port, the fedrann_tpu_torch package of the checkout DIR is timed (an
earlier commit unpacked by `git archive`), this checkout's chip_smoke.py
drives it. Exits non-zero where no card is visible.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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

    card = f"{torch.cuda.get_device_name(0)}, {args.port}"
    dev = torch.device("cuda")
    _build.build()
    _build.kernels()
    rows = cs.overlap_rows(cs.IVF_ROWS, dev)
    (ref, _), exact_secs, _ = cs.measured(
        lambda: knn_exact(rows, cs.IVF_K, transfer="f32"), [dev])
    _, cold, _ = cs.measured(lambda: ivf.knn_ivf(rows, cs.IVF_K,
                                                 transfer="f32"), [dev])
    (idx, _), warm, _ = cs.measured(lambda: ivf.knn_ivf(
        rows, cs.IVF_K, transfer="f32"), [dev])
    # the launch counts of the kernels the timed package has
    kernels = {name: fn for name, fn in (
        ("K4", merge_block), ("K6", getattr(ivf, "rescore_clusters", None)),
        ("K7", getattr(ivf, "merge_probe_lists", None)),
        ("K9", getattr(ivf, "segment_sum_rows", None)),
        ("K10", getattr(topk, "result_wire", None)),
        ("K11", getattr(ivf, "cluster_tables", None))) if fn is not None}
    counts = {name: fn.kernel_launches for name, fn in kernels.items()}
    with cs.ivf_step_split() as split:
        _, secs, _ = cs.measured(lambda: ivf.knn_ivf(
            rows, cs.IVF_K, transfer="f32"), [dev])
    after = {name: fn.kernel_launches for name, fn in kernels.items()}
    rng = np.random.default_rng(int(cs.FLAGS[cs.FLAGS.index("--seed") + 1]))
    sample = np.sort(rng.choice(cs.IVF_ROWS, cs.IVF_SAMPLE, replace=False))
    last = ivf.knn_ivf.last
    cs.log(f"11b split run: knn_ivf {warm:.4f} s warm, {cold:.4f} s cold, "
           f"{secs:.4f} s split; knn_exact {exact_secs:.4f} s; C = "
           f"{last['clusters']}, largest cluster {last['max_members']}, "
           f"{last['pair_scores']:.4g} padded pair-scores, "
           f"{last.get('real_pair_scores', float('nan')):.4g} real; recall "
           f"{cs.sample_recall(idx, ref, sample):.5f} on {cs.IVF_SAMPLE} "
           f"queries; launches in the split run "
           f"{ {k: after[k] - counts[k] for k in after} } [{card}]")
    cs.log_ivf_split("11b knn_ivf", split, secs * 1e3, card)


if __name__ == "__main__":
    main()
