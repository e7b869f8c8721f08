"""Two processes of fedrann_tpu_torch's multi-process runtime (gloo, on
the CPU) against the JAX package's single-process `run_pipeline`, on
tests/test_multihost_2proc.py's dataset and flags (its 1024/2048 buckets
split the reads past 2,048 bases) and by that test's bars:

- the global library equals the single-process one bitwise;
- the merged overlaps.tsv against JAX's: query coverage 1.0, recall@k >
  0.995 and distance MAE < 1e-3 (tile orders differ, so near ties may
  swap; the port breaks ties by the lowest index, JAX's ring by arrival);
- the rank tables are removed after the merge (kept under
  --keep-intermediates) and metrics.rank<r>.json holds all seven stages.

The k-NN runs as ring, ring2d, allgather, FEDRANN_TPU_MULTIHOST_KNN=
host and --knn-method ivf (every cluster probed); with --no-pack-cache
each rank parses its byte range of the FASTA; a --keep-intermediates run
is resumed with no staging and a byte-identical table. A rank that
raises takes the other down. Each launch waits on both ranks with a
timeout and kills both when it expires.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-k", "13", "--kmer-sample-fraction", "0.2",
         "--kmer-min-multiplicity", "2", "-n", "128",
         "--nndescent-n-neighbors", "10", "--seed", "7",
         "--length-buckets", "1024,2048"]
STAGES = ("load", "stage", "count", "project", "embed", "knn", "output")
TIMEOUT = 240  # seconds for both ranks of one launch

DRIVER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(2)
from fedrann_tpu_torch.cli import config_from_args
from fedrann_tpu_torch.parallel.runtime import run_pipeline_multihost
from fedrann_tpu_torch.knn.ivf import knn_ivf_sharded_multihost as ivf
res = run_pipeline_multihost(config_from_args({args!r}), torch.device("cpu"),
                             [torch.device("cpu")] * {entries})
codes, counts = res.library.numpy()
np.savez({lib!r}, codes=codes, counts=counts)
print("IVF_COUNTS", json.dumps({{"calls": ivf.calls,
                                "exact_fallbacks": ivf.exact_fallbacks}}))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(fasta: str, out: str, extra=(), knn: str | None = None,
           entries: int = 1, knn_by_rank=None, check: bool = True):
    """Both ranks of one run, each with `entries` local k-NN entries of
    the CPU and FEDRANN_TPU_MULTIHOST_KNN = knn (or knn_by_rank[rank]);
    returns their outputs (stdout + stderr), and with check=False their
    exit codes too."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="2")
        env.pop("FEDRANN_TPU_MULTIHOST_KNN", None)
        rank_knn = knn if knn_by_rank is None else knn_by_rank[rank]
        if rank_knn is not None:
            env["FEDRANN_TPU_MULTIHOST_KNN"] = rank_knn
        args = ["-i", fasta, "-o", out, *FLAGS, *extra,
                "--num-processes", "2", "--process-id", str(rank),
                "--coordinator", coord]
        code = DRIVER.format(repo=REPO, args=args, entries=entries,
                             lib=os.path.join(out, f"lib.rank{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if not check:
        return outs, [p.returncode for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The dataset and the JAX package's single-process run on it."""
    from fedrann_tpu.cli import config_from_args
    from fedrann_tpu.pipeline import run_pipeline
    from fedrann_tpu.sim import simulate_reads, write_fasta

    tmp = tmp_path_factory.mktemp("multihost")
    sim = simulate_reads(genome_length=20000, coverage=6,
                         mean_read_length=1800, error_rate=0.02, seed=7)
    fasta = str(tmp / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    assert any(len(s) > 2048 for s in sim.sequences), \
        "dataset must contain a read longer than the largest bucket"
    out = str(tmp / "single")
    res = run_pipeline(config_from_args(["-i", fasta, "-o", out, *FLAGS]))
    return fasta, os.path.join(out, "overlaps.tsv"), res.library, tmp


def check_run(single, out: str, outs: list[str], keep: bool = False,
              stages_run=STAGES):
    from fedrann_tpu_torch.eval import OverlapTable, neighbor_recall

    _, ref_tsv, library, _ = single
    for rank in range(2):
        lib = np.load(os.path.join(out, f"lib.rank{rank}.npz"))
        assert np.array_equal(lib["codes"], library.codes), rank
        assert np.array_equal(lib["counts"], library.counts), rank
    merged = os.path.join(out, "overlaps.tsv")
    assert os.path.exists(merged), outs[0][-2000:]
    for rank in range(2):
        assert os.path.exists(
            os.path.join(out, f"overlaps.rank{rank}.tsv")) == keep
    rep = neighbor_recall(OverlapTable.read(ref_tsv),
                          OverlapTable.read(merged))
    assert rep.query_coverage == 1.0, rep
    assert rep.recall_at_k > 0.995, rep
    assert rep.distance_mae < 1e-3, rep
    for rank in range(2):
        with open(os.path.join(out, f"metrics.rank{rank}.json")) as f:
            stages = json.load(f)
        for s in stages_run:
            assert s in stages, (rank, s, stages.keys())
        assert stages["knn"]["flops"] > 0 and stages["knn"]["d2h_bytes"] > 0
        assert stages["transport"]["kind"] == "gloo"


@pytest.mark.parametrize("knn", ["ring", "host"])
def test_two_processes_match_single(single, knn):
    fasta, _, _, tmp = single
    out = str(tmp / f"multi_{knn}")
    outs = launch(fasta, out, knn=knn)
    check_run(single, out, outs)
    assert all("device transport: gloo" in o for o in outs)


@pytest.mark.parametrize("strategy", ["ring", "ring2d", "allgather"])
def test_two_processes_match_single_strategy(single, strategy):
    """The strategy by --knn-shard-strategy, as one process reads it, over
    two local entries a rank (the quota rounded so 2 * per rows divide
    over them; a block moves inside a rank and between ranks)."""
    fasta, _, _, tmp = single
    out = str(tmp / f"multi_{strategy}_x2")
    outs = launch(fasta, out, ["--knn-shard-strategy", strategy], entries=2)
    check_run(single, out, outs)
    assert all(f"k-NN {strategy} over 2 processes x 2 local entries" in o
               for o in outs)


def test_two_processes_byte_range_parse(single):
    """Without the shared cache each rank scans half of the FASTA and
    parses only its own records' bytes."""
    fasta, _, _, tmp = single
    out = str(tmp / "multi_ranged")
    outs = launch(fasta, out, ["--no-pack-cache"])
    check_run(single, out, outs)
    assert not os.path.exists(os.path.join(out, "fxcache.npz"))
    for rank, o in enumerate(outs):
        m = re.search(r"byte-range parse:.*\((\d+\.\d)% of input\)", o)
        assert m, (rank, o[-2000:])
        assert float(m.group(1)) < 70.0, m.group(0)


def test_two_processes_checkpoint_resume(single):
    """--keep-intermediates: the library checkpoint and each rank's
    embeddings; a second launch resumes both (no staging) and writes the
    same merged table, byte for byte; the rank tables are kept."""
    fasta, _, _, tmp = single
    out = str(tmp / "multi_ckpt")
    outs = launch(fasta, out, ["--keep-intermediates"])
    check_run(single, out, outs, keep=True)
    assert all("stage stage:" in o for o in outs)
    ckpt = os.path.join(out, "checkpoints")
    assert os.path.exists(os.path.join(ckpt, "library.npz"))
    for rank in range(2):
        assert os.path.exists(
            os.path.join(ckpt, f"embeddings.rank{rank}.npy"))
    with open(os.path.join(out, "overlaps.tsv"), "rb") as f:
        first = f.read()
    outs = launch(fasta, out, ["--keep-intermediates"])
    for o in outs:
        assert "resuming library" in o and "resuming embeddings" in o, o
        assert "stage stage:" not in o
    with open(os.path.join(out, "overlaps.tsv"), "rb") as f:
        assert f.read() == first
    # a resumed run has no "stage" (as in the single-process metrics.json)
    check_run(single, out, outs, keep=True,
              stages_run=[s for s in STAGES if s != "stage"])


def ivf_counts(out: str) -> dict:
    """A rank's knn_ivf_sharded_multihost counts, as each rank prints
    them."""
    m = re.search(r"^IVF_COUNTS (.*)$", out, re.M)
    assert m, out[-2000:]
    return json.loads(m.group(1))


@pytest.mark.parametrize("entries", [1, 2])
def test_two_processes_ivf_match_single(single, entries):
    """--knn-method ivf with C = p = 16 (tests/test_multihost_2proc.py's
    two-process IVF test), with one and two local entries a rank: each
    rank runs knn_ivf_sharded_multihost past its valve, and with every
    cluster probed the merged table matches the single-process exact one
    by check_run's bars."""
    fasta, _, _, tmp = single
    out = str(tmp / f"multi_ivf_x{entries}")
    outs = launch(fasta, out, ["--knn-method", "ivf", "--knn-ivf-clusters",
                               "16", "--knn-ivf-probes", "16"],
                  entries=entries)
    check_run(single, out, outs)
    for o in outs:
        assert ivf_counts(o) == {"calls": 1, "exact_fallbacks": 0}
        assert (f"IVF k-NN over 2 processes x {entries} local entries"
                in o)


def test_a_failing_rank_fails_the_other(single):
    """Rank 1 raises in the k-NN (an unknown strategy) while rank 0 waits
    on its block: both exit non-zero well inside the launch timeout, and
    no merged table is written."""
    import time

    fasta, _, _, tmp = single
    out = str(tmp / "multi_fail")
    t0 = time.perf_counter()
    outs, rcs = launch(fasta, out, knn_by_rank=["ring", "bogus"],
                       check=False)
    assert rcs[0] != 0 and rcs[1] != 0, rcs
    assert "strategy must be one of" in outs[1]
    assert time.perf_counter() - t0 < TIMEOUT / 2
    assert not os.path.exists(os.path.join(out, "overlaps.tsv"))
