"""Runs of one cell in fresh processes, one after another, and the spread
of each metric: what a bound is set from.

    python3 portbench/series.py --workload <cell> --seeds S1 S2 ... \
        --seconds <s> [--trace 1] [--out results.jsonl]

Each run is `python3 portbench/run.py` with its own seed; each run's
result line (and its exit code, and the end of its standard error when it
fails) goes to --out as one JSON line. Then, for each metric, the median,
the quartiles (statistics.quantiles(values, n=4)) and the spread, the
distance between the quartiles over the median, and the same with the
run farthest from the median left out."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values: list[float]) -> float:
    """The distance between the first and the third quartile over the
    median (0 for fewer than two values or a zero median)."""
    if len(values) < 2:
        return 0.0
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else 0.0


def trimmed(values: list[float]) -> list[float]:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def summary(results: list[dict]) -> dict:
    """metric -> {median, q1, q3, spread, spread_trimmed, n} over the
    results that printed one."""
    names = sorted({m for r in results for m in r.get("metrics", {})})
    out = {}
    for name in names:
        vals = [r["metrics"][name]["value"] for r in results
                if name in r.get("metrics", {})]
        q = statistics.quantiles(vals, n=4) if len(vals) > 1 else \
            [vals[0]] * 3
        out[name] = {"median": statistics.median(vals), "q1": q[0],
                     "q3": q[2], "spread": spread(vals),
                     "spread_trimmed": spread(trimmed(vals))
                     if len(vals) > 2 else 0.0, "n": len(vals)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    results = []
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            proc = subprocess.run(
                [sys.executable, str(RUN), "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace)],
                capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if proc.returncode == 0 \
                    else {}
            except (IndexError, json.JSONDecodeError):
                result = {}
            record = {"workload": args.workload, "seed": seed,
                      "seconds": args.seconds, "trace": args.trace,
                      "rc": proc.returncode, "result": result}
            record["log"] = [line for line in proc.stderr.splitlines()
                             if line.startswith("portbench")]
            if proc.returncode != 0 or not result.get("correct"):
                record["stderr_tail"] = proc.stderr[-4000:]
            print(json.dumps(record), flush=True)
            if out:
                out.write(json.dumps(record) + "\n")
                out.flush()
            if result:
                results.append(result)
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": args.workload, "runs": len(args.seeds),
                      "with_result": len(results),
                      "correct": sum(bool(r.get("correct"))
                                     for r in results),
                      "summary": summary(results)}), flush=True)
    return 0 if len(results) == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
