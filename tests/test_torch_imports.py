"""fedrann_tpu_torch imports neither jax nor fedrann_tpu, CPU tensors take
the plain versions (no kernel launch), and chip_smoke.py fails without a
GPU or without the repository around it."""

from __future__ import annotations

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fedrann_tpu_torch
from fedrann_tpu_torch import probes
from fedrann_tpu_torch.kmers import codec, membership
from fedrann_tpu_torch.project import embed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        fedrann_tpu_torch.__path__, "fedrann_tpu_torch.")
        if m.name != "fedrann_tpu_torch.__main__")


def test_port_imports_without_jax():
    """Every module imports with jax and fedrann_tpu made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['fedrann_tpu'] = None\n"
        "import importlib\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'fedrann_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(_port_modules()) >= 20
    assert {"fedrann_tpu_torch.parallel.mesh",
            "fedrann_tpu_torch.parallel.step",
            "fedrann_tpu_torch.parallel.dist",
            "fedrann_tpu_torch.parallel.runtime",
            "fedrann_tpu_torch.oracle",
            "fedrann_tpu_torch.eval",
            "fedrann_tpu_torch.knn.ring"} <= set(_port_modules())


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    bases = torch.from_numpy(rng.integers(0, 5, (8, 3000)).astype(np.uint8))
    before = (codec.canonical_sample.launches,
              membership.select_candidates.long_launches,
              membership.stage_candidates.launches,
              embed.membership_embed.launches)
    thr = codec.sample_threshold(0.3)
    slots = codec.canonical_sample(bases, 15, 1, thr, False)
    assert torch.equal(slots,
                       codec._canonical_sample_plain(bases, 15, 1, thr, False))
    staged, dropped = membership.select_candidates(slots, 1024, False, 316)
    want = membership._select_candidates_plain(slots, 1024, False, 316)
    assert torch.equal(staged, want[0]) and torch.equal(dropped, want[1])
    fused = membership.stage_candidates(bases, 15, 1024, False, 1, thr, 316)
    assert torch.equal(fused[0], want[0]) and torch.equal(fused[1], want[1])
    lib = torch.unique(staged[staged != codec.PAD_SLOT] >> 1)
    signs = torch.zeros((lib.shape[0] + 1, 4), dtype=torch.int32)
    mags = torch.ones(lib.shape[0] + 1)
    out = torch.zeros((16, 32))
    targets = torch.stack([2 * torch.arange(8), 2 * torch.arange(8) + 1], 1)
    embed.membership_embed(staged, lib, signs, mags, targets, out)
    assert (codec.canonical_sample.launches,
            membership.select_candidates.long_launches,
            membership.stage_candidates.launches,
            embed.membership_embed.launches) == before


def test_cpu_tensors_take_the_plain_long_path_and_probes():
    """Rows past a block's shared memory and the probe wrappers take the
    plain versions on the CPU and count no launch."""
    before = (membership.select_candidates.long_launches,
              *(fn.launches for fn in probes.WRAPPERS.values()))
    slots = torch.full((2, 40000), codec.PAD_SLOT, dtype=torch.int64)
    slots[0, ::7] = torch.arange(0, 40000, 7)
    assert membership.stage_launch_plan(40000, 40000, True, None).long
    staged, dropped = membership.select_candidates(slots, 40000, True, None)
    want = membership._select_candidates_plain(slots, 40000, True, None)
    assert torch.equal(staged, want[0]) and torch.equal(dropped, want[1])
    res = probes.run("all", torch.device("cpu"))
    assert set(res) == {"P1", "P2", "P3", "P4", "P5", "P6"}
    assert before == (membership.select_candidates.long_launches,
                      *(fn.launches for fn in probes.WRAPPERS.values()))
    assert not hasattr(membership.select_candidates, "launches")


def test_one_block_rows_are_not_selected_from_slots():
    """Kernel B reads slots on its device-memory path only: a plan that
    keeps rows in one block (they stage fused, from their bases) is
    refused before anything launches, naming stage_candidates."""
    plan = membership.stage_launch_plan(16370, 1024, False, 80)
    assert not plan.long
    slots = torch.full((2, 16370), codec.PAD_SLOT, dtype=torch.int64)
    with pytest.raises(ValueError, match="stage_candidates"):
        membership._select_on_card(slots, 1024, plan)


def test_probes_entry_point_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "fedrann_tpu_torch.probes", "bsearch"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "OK" not in proc.stdout


def test_get_device_refuses_a_missing_gpu():
    from fedrann_tpu_torch.device import get_device

    assert get_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device("cuda")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
