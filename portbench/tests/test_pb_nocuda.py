"""Without a CUDA card the harness exits with an error and prints no
result: it never falls back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hifi-dmel.exact",
         "--seed", str(2**31 + 12345), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA card" in proc.stderr


def test_an_unknown_cell_has_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "no-such.cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout
