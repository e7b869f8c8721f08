"""The readings a limit of portbench/cells/<cell>.json is set from, at
the cell's own size, in one process:

    python3 portbench/control.py --workload <cell> --seeds S1 S2 ... \
        [--seconds 3] [--fault control|stale|half|altered|probes_half|...]

For each seed, one run of the cell with a short window (run.run_cell, as
portbench/run.py drives it but for its look for a card), unbroken or with
--fault planted (portbench/faults.py; `control` puts the control, the
exact search on rows rounded to fp8, in the program's place): its
`correct`, as the harness decides it, and every compared number. One JSON
line a seed."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402
from portbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = p.parse_args(argv)
    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in args.seeds:
        start = time.perf_counter()
        result, _ = run_cell(cell, seed, args.seconds, False, device, start,
                             wrap=FAULTS.get(args.fault),
                             log=lambda *a, **kw: None)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "fault": args.fault,
            "correct": result["correct"], "jobs": result["attempted"],
            "seconds": round(time.perf_counter() - start, 3),
            "readings": {n: c["value"]
                         for n, c in result["checks"].items()}}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
