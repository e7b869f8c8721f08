"""The plain reference and the comparison that decides `correct`, against
the port's numpy oracle (float64) and the port's own search on the CPU;
the truth recall's copied arithmetic against the port's eval."""

import numpy as np
import pytest
import torch

from portbench.gen import Dataset, Features, make_read_set
from portbench.reference import knn as ref
from portbench.reference.recall import truth_found

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rows():
    return make_read_set(Dataset(400_000, 30, 10_000, 0.05),
                         Features(16, 0.005, 2, 500, 0.0006), 21, CPU).rows


def test_kth_scores_match_the_float64_oracle(rows):
    from fedrann_tpu_torch.oracle import knn_cosine

    q = torch.arange(0, rows.shape[0], 97)
    _, dist = knn_cosine(rows.numpy(), 20)
    got = ref.kth_scores(ref.unit_rows(rows), q, 20)
    assert np.allclose(got.numpy(), 1.0 - dist[q.numpy(), -1], atol=1e-5)


def test_the_programs_search_passes_and_the_control_fails(rows):
    from fedrann_tpu_torch.knn.topk import knn_exact

    idx, dist = knn_exact(rows, 50, precision="bf16", transfer="u16")
    q = np.arange(0, rows.shape[0], 7)
    names = ("dist_err", "rank_gap", "exact_miss")
    sound = ref.judge(rows, q, idx[q], dist[q], 50, names)
    # bf16's unit roundoff 2^-8, twice, bounds a pair's error
    assert sound["dist_err"] <= 2.0**-7 + 1e-4
    assert sound["rank_gap"] <= 2.0**-7
    c_idx, c_dist = ref.control_search(rows, torch.from_numpy(q), 50)
    control = ref.judge(rows, q, c_idx, c_dist, 50, names)
    assert control["dist_err"] > 3 * sound["dist_err"]
    assert control["rank_gap"] > 3 * sound["rank_gap"]
    # bf16 swaps a few neighbors at the k-th score, no more
    assert sound["exact_miss"] <= 0.02


def test_exact_miss_counts_what_a_list_leaves_out(rows):
    from fedrann_tpu_torch.oracle import knn_cosine

    q = np.arange(0, rows.shape[0], 11)
    idx, dist = knn_cosine(rows.numpy(), 20)
    idx, dist = idx[q].astype(np.int32), dist[q].astype(np.float32)
    names = ("exact_miss",)
    assert ref.judge(rows, q, idx, dist, 20, names)["exact_miss"] == 0.0
    # the last five of each list swapped for the rows ranked 21-25
    wide, wide_d = knn_cosine(rows.numpy(), 25)
    idx[:, 15:], dist[:, 15:] = wide[q, 20:], wide_d[q, 20:]
    got = ref.judge(rows, q, idx, dist, 20, names)["exact_miss"]
    # a row whose 20th and 21st scores tie loses less
    assert 0.2 * 0.9 <= got <= 0.25


@pytest.mark.parametrize("fault", ["unset", "twice", "order", "range",
                                   "shape"])
def test_a_broken_answer_reads_broken(rows, fault):
    from fedrann_tpu_torch.knn.topk import knn_exact

    q = np.arange(0, 40)
    idx, dist = knn_exact(rows[:2000], 10, precision="bf16", transfer="u16")
    idx, dist = idx[q].copy(), dist[q].copy()
    if fault == "unset":
        idx[3, 4], dist[3, 4] = -1, np.inf
    elif fault == "twice":
        idx[5, 2] = idx[5, 1]
    elif fault == "order":
        dist[7, [2, 3]] = dist[7, [3, 2]] + np.float32([0.0, 0.01])
    elif fault == "range":
        idx[9, 9] = 2000
    else:
        idx, dist = idx[:, :9], dist[:, :9]
    names = ("dist_err", "rank_gap", "exact_miss")
    got = ref.judge(rows[:2000], q, idx, dist, 10, names)
    assert got == dict.fromkeys(names, ref.BROKEN)


def test_truth_found_is_eval_truth_recall():
    from fedrann_tpu_torch.eval import truth_recall

    rng = np.random.default_rng(3)
    n_reads = 300
    idx = rng.integers(-1, 2 * n_reads, size=(2 * n_reads, 12)).astype(
        np.int32)
    pairs = sorted({tuple(sorted(p)) for p in
                    rng.integers(0, n_reads, size=(2000, 2)).tolist()
                    if p[0] != p[1]})
    found = truth_found(idx, torch.tensor(pairs), block=257)
    assert found / len(pairs) == truth_recall(idx, pairs, n_reads)
