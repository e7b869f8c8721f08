"""The k-NN result wire: the port's keys_to_host_plain (knn/topk.py, the
plain version of kernel K10) against the JAX package's transfer_idx and
transfer_dist (fedrann_tpu/knn/topk.py) on the same seeded scores.

The port keeps a search's result as int64 keys (topk._order_keys of the
scores and the candidate indices). JAX's functions take the decoded
values: distances 1 - score (inf in an unset slot) and indices (-1 in
one), made here with numpy from the same scores, so the decode is held to
the JAX package too. Tolerance: none (every value bit for bit), but where
JAX's uint16 index wire clips an unset slot's -1 to 0 (it carries no
spare value); the port keeps -1 there, as on its other wires.

K10 itself runs only on a card: tests/test_torch_kernels.py holds it to
keys_to_host_plain there (`-m cuda`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrann_tpu.knn import topk as jtopk
from fedrann_tpu_torch import _build, metrics
from fedrann_tpu_torch.knn import topk
from fedrann_tpu_torch.knn.topk import (
    EMPTY_KEY,
    _order_keys,
    keys_to_host,
    keys_to_host_plain,
    result_wire,
)
from fedrann_tpu_torch.pipeline import add_knn_work


def _keys(scores: np.ndarray, ids: np.ndarray, empty: np.ndarray):
    """int64 keys of float32 scores and int64 ids, EMPTY_KEY where
    `empty`; and JAX's inputs: (indices int32 with -1, distances float32
    1 - score with inf) where empty."""
    keys = _order_keys(torch.from_numpy(scores.copy()), torch.from_numpy(ids))
    keys[torch.from_numpy(empty)] = EMPTY_KEY
    dist = np.where(empty, np.float32(np.inf), np.float32(1.0) - scores)
    idx = np.where(empty, -1, ids).astype(np.int32)
    return keys, idx, dist.astype(np.float32)


def _jax_wire(idx, dist, transfer: str, n_rows: int):
    return (np.asarray(jtopk.transfer_idx(jnp.asarray(idx), transfer,
                                          n_rows)),
            np.asarray(jtopk.transfer_dist(jnp.asarray(dist), transfer)))


def _hold(got, want, empty, clipped: bool) -> None:
    """got's (indices, distances) against JAX's want, bit for bit (int32
    views of the distances); with `clipped` JAX's uint16 index wire gave 0
    where the port gives -1."""
    (gi, gd), (wi, wd) = got, want
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    assert gi.shape == wi.shape and gd.shape == wd.shape
    if clipped:
        assert (gi[empty] == -1).all() and (wi[empty] == 0).all()
        wi = np.where(empty, -1, wi)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd.view(np.int32), wd.view(np.int32))


@pytest.mark.parametrize("empty_slots", ["none", "some"])
@pytest.mark.parametrize("n_rows", [40_000, 300_000])
@pytest.mark.parametrize("transfer", ["f32", "u16"])
def test_keys_to_host_plain_is_jax_wire(transfer, n_rows, empty_slots):
    """Seeded scores in [-1, 1] (some a bf16 overshoot past 1), distinct
    indices below n_rows, rows of k = 50: keys_to_host_plain equals
    transfer_idx + transfer_dist on the decoded values. n_rows = 40,000
    crosses as uint16 indices under u16 (u16_indices), 300,000 as JAX's
    20-bit packed wire (bit-identical to int32, by its own docstring) and
    the port's int32; some: a fifth of the slots unset, and whole rows."""
    rng = np.random.default_rng(n_rows + len(transfer) + len(empty_slots))
    rows, k = 300, 50
    scores = rng.uniform(-1.0, 1.0, (rows, k)).astype(np.float32)
    scores[0, :5] = np.nextafter(np.float32(1.0), np.float32(2.0))
    ids = np.stack([rng.choice(n_rows, k, replace=False)
                    for _ in range(rows)]).astype(np.int64)
    empty = np.zeros((rows, k), bool)
    if empty_slots == "some":
        empty = rng.random((rows, k)) < 0.2
        empty[3] = True
    keys, idx, dist = _keys(scores, ids, empty)
    got = keys_to_host_plain(keys, transfer, n_rows)
    want = _jax_wire(idx, dist, transfer, n_rows)
    clipped = empty.any() and topk.u16_indices(transfer, n_rows)
    _hold(got, want, empty, clipped)
    if empty.any():
        assert (got[1][empty] == (2.0 if transfer == "u16" else np.inf)).all()


def _half_steps(rng, count: int) -> np.ndarray:
    """Scores s whose distance's grid position float32(1 - s) * 32767.5 is
    an exact half (k + 0.5), with k even: round half to even goes down,
    half away from zero up."""
    s = rng.uniform(-1.0, 1.0, 400_000).astype(np.float32)
    t = (np.float32(1.0) - s) * np.float32(32767.5)
    frac = t - np.floor(t)
    pick = s[(frac == np.float32(0.5)) & (np.floor(t) % 2 == 0)]
    assert pick.size >= count
    return pick[:count]


@pytest.mark.parametrize("transfer", ["f32", "u16"])
def test_keys_to_host_plain_edge_scores(transfer):
    """The wire's traps, against JAX and against their own values: a
    score of -0.0 (distance 1.0), exactly 1.0 (distance +0.0), -1.0
    (distance 2.0, grid step 65,535), a bf16 overshoot just past 1 (a
    negative distance: on the u16 grid step 0, +0.0 and not -0.0) and
    just below -1 (1 - s rounds to 2.0), and scores whose grid position
    is an exact half with an even floor (round half to even: the step
    below; roundf would take the one above); the dequantizing factor is
    np.float32(1 / 32767.5)."""
    rng = np.random.default_rng(20)
    over = np.nextafter(np.float32(1.0), np.float32(2.0))
    under = np.nextafter(np.float32(-1.0), np.float32(-2.0))
    special = np.array([-0.0, 0.0, 1.0, -1.0, over, under], np.float32)
    half = _half_steps(rng, 26)
    scores = np.concatenate([special, half]).reshape(4, 8)
    ids = np.arange(scores.size, dtype=np.int64).reshape(scores.shape)
    empty = np.zeros(scores.shape, bool)
    keys, idx, dist = _keys(scores, ids, empty)
    got = keys_to_host_plain(keys, transfer, 100)
    _hold(got, _jax_wire(idx, dist, transfer, 100), empty, False)
    d = got[1].reshape(-1)
    np.testing.assert_array_equal(got[0].reshape(-1), np.arange(32))
    if transfer == "f32":
        assert d[0] == 1.0 and d[2] == 0.0 and not np.signbit(d[2])
        assert d[3] == d[5] == 2.0 and d[4] < 0
        np.testing.assert_array_equal(d[6:], np.float32(1.0) - half)
    else:
        inv = np.float32(1.0 / 32767.5)
        steps = np.rint((np.float32(1.0) - half) * np.float32(32767.5))
        assert (steps % 2 == 0).all()
        np.testing.assert_array_equal(
            d[6:], steps.astype(np.float32) * inv)
        assert d[0] == np.float32(32768) * inv and d[2] == 0.0
        assert not np.signbit(d[2]) and not np.signbit(d[4]) and d[4] == 0.0
        assert d[3] == d[5] == np.float32(65535) * inv == 2.0


def test_cpu_keys_never_reach_the_kernel(monkeypatch):
    """keys_to_host on CPU keys runs the plain version: no launch (a
    launch would raise here), K10's count unchanged, the plain result;
    result_wire itself refuses CPU keys."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel launch on CPU keys")

    monkeypatch.setattr(_build, "launch", refuse)
    rng = np.random.default_rng(4)
    scores = rng.uniform(-1, 1, (20, 7)).astype(np.float32)
    keys, _, _ = _keys(scores, np.tile(np.arange(7), (20, 1)),
                       np.zeros((20, 7), bool))
    before = result_wire.kernel_launches
    for transfer in ("f32", "u16"):
        got = keys_to_host(keys, transfer, 7)
        want = keys_to_host_plain(keys, transfer, 7)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert result_wire.kernel_launches == before
    with pytest.raises(ValueError, match="result_wire"):
        result_wire(keys, "f32", 7)


@pytest.mark.parametrize("transfer,n_rows,wire", [
    ("f32", 40_000, 8), ("u16", 40_000, 4), ("u16", 65_536, 4),
    ("u16", 300_000, 6), ("f32", 300_000, 8)])
def test_d2h_entry_bytes_count_what_crosses(transfer, n_rows, wire):
    """The bytes a neighbor entry takes to the host: from CPU keys the
    JAX package's wire, which keys_to_host_plain copies (2 or 4 bytes of
    distance, 2 or 4 of index); from a card K10's final int32 index and
    float32 distance, 8 on either wire. The knn stage's d2h_bytes counts
    them by the search's device."""
    assert topk.d2h_entry_bytes(transfer, n_rows, torch.device("cpu")) \
        == wire
    assert topk.d2h_entry_bytes(transfer, n_rows, torch.device("cuda")) == 8
    idx = np.zeros((30, 7), np.int32)
    for device, per in ((torch.device("cpu"), wire),
                        (torch.device("cuda", 0), 8)):
        m = metrics.StageMetrics(torch.device("cpu"))
        add_knn_work(m, 30, n_rows, 16, idx, transfer, device)
        assert m.summary()["knn"]["d2h_bytes"] == 30 * 7 * per
