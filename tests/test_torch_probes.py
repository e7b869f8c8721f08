"""The port's capability probes (`fedrann_tpu_torch.probes`, plain
versions) against the Mosaic probes of bench/probe_mosaic.py and
bench/probe_mosaic2.py run in Pallas interpret mode, and kernel B's launch
plan against the shared-memory limit.

Each JAX probe runs unchanged with `pallas_call` wrapped so that it
interprets on the CPU and records what every call returns (or, for P2/P5
at other inputs, the interpreted function itself). Integer probes (P1, P2,
P4, P5) and the float store P6-B must agree bitwise; the float
accumulations (P3, P6-A, P6-C) to rtol 1e-5 and atol 1e-6 * (terms summed
per output) * max|q|, since float32 sums may be taken in another order.
The P3/P6 kernel's own order, replayed on tensors (`_dyn_rows_replay` over
`dyn_rows_order`), must equal the interpreted probes bitwise in every
mode. A numpy emulation of P4's kernel schedule (`_bsearch_schedule`)
must give torch.searchsorted's position for every query."""

from __future__ import annotations

import os
import sys

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench"))

import probe_mosaic  # noqa: E402
import probe_mosaic2  # noqa: E402
from fedrann_tpu_torch import probes  # noqa: E402
from fedrann_tpu_torch.config import PipelineConfig  # noqa: E402
from fedrann_tpu_torch.device import SM90_SMEM_OPTIN  # noqa: E402
from fedrann_tpu_torch.kmers.membership import (  # noqa: E402
    SELECT_BLOCK,
    STATIC_SMEM,
    _selection_plan,
    stage_launch_plan,
)
from fedrann_tpu_torch.pipeline import staging_params  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def interpret(monkeypatch):
    """Make every pallas_call interpret; returns the list of calls, each
    the list of outputs (numpy) of the function it built."""
    real = pl.pallas_call
    records: list[list[np.ndarray]] = []

    def pallas_call(kernel, *args, **kwargs):
        kwargs["interpret"] = True
        fn = real(kernel, *args, **kwargs)
        outs: list[np.ndarray] = []
        records.append(outs)

        def call(*xs):
            out = fn(*xs)
            outs.append(np.asarray(out))
            return out

        return call

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    return records


def _no_fail(capsys):
    text = capsys.readouterr().out
    assert "FAIL" not in text, text


@pytest.fixture(scope="module")
def port():
    return probes.run("all", CPU)


def test_probe_inputs_are_the_scripts_arrays():
    a = probes.probe_inputs()
    assert a["x"].shape == (64, 2048) and a["x"].dtype == np.int32
    assert a["q"].shape == (512, 1024) and a["q"].dtype == np.float32
    np.testing.assert_array_equal(
        a["q"], np.random.default_rng(0).normal(size=(512, 1024)).astype(
            np.float32))
    assert a["idx"].max() < 512 and a["row"].max() < probes.E_ROWS
    assert np.all(np.diff(a["table"]) >= 0)
    assert a["queries"].shape == (1 << 14,)


def test_p1_smem_scratch(interpret, capsys, port):
    probe_mosaic.probe_smem_scratch()
    _no_fail(capsys)
    assert [len(c) for c in interpret] == [1] * len(probes.SCRATCH_SIZES)
    for calls, step in zip(interpret, port["P1"]):
        np.testing.assert_array_equal(calls[0], step.out.numpy())
        assert calls[0].dtype == np.int32
    assert probes.scratch_ladder_problems(port["P1"], None) == []


@pytest.mark.parametrize("which,script", [("P2", probe_mosaic),
                                          ("P5", probe_mosaic2)])
def test_p2_p5_smem_input(interpret, capsys, port, which, script):
    script.probe_smem_input()
    _no_fail(capsys)
    (calls,) = interpret
    np.testing.assert_array_equal(calls[0], port[which].numpy())
    assert int(port[which][0]) == 1818744


@pytest.mark.parametrize("script", [probe_mosaic, probe_mosaic2])
def test_p2_p5_full_range_sums_wrap_like_int32(monkeypatch, capsys, script):
    """At full-range random int32 blocks the plain version's step sums wrap
    like int32: every step against int64 sums wrapped to int32 (some of
    which overflow), the last against the interpreted Pallas probe."""
    built = []
    real = pl.pallas_call

    def pallas_call(kernel, *args, **kwargs):
        kwargs["interpret"] = True
        built.append(real(kernel, *args, **kwargs))
        return built[-1]

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    script.probe_smem_input()
    _no_fail(capsys)
    (fn,) = built
    info = np.iinfo(np.int32)
    x = np.random.default_rng(3).integers(info.min, info.max, (64, 2048),
                                          dtype=np.int32, endpoint=True)
    steps = torch.cat([probes._smem_input_plain(blk) for blk in
                       torch.from_numpy(x).split(probes.INPUT_ROWS)]).numpy()
    np.testing.assert_array_equal(
        probes._smem_input_plain(torch.from_numpy(x)).numpy(),
        np.asarray(fn(jnp.asarray(x))))
    np.testing.assert_array_equal(steps[-1:], np.asarray(fn(jnp.asarray(x))))
    i = np.arange(probes.INPUT_ROWS)
    wide = x.reshape(4, probes.INPUT_ROWS, 2048).astype(np.int64)[
        :, i, i & 1023].sum(axis=1)
    wrapped = (wide + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(steps, wrapped.astype(np.int32))
    assert np.any(wide != wrapped)


def _bsearch_schedule(table: np.ndarray, queries: np.ndarray,
                      sms: int = 132) -> tuple[np.ndarray, int]:
    """fk_probe_bsearch's schedule in numpy: (each query's position, the
    int32 sum). min(groups, sms) blocks; block b takes rounds b, b +
    blocks, ... of BSEARCH_THREADS * BSEARCH_PER queries; thread t of a
    round searches queries round + j * BSEARCH_THREADS + t, j <
    BSEARCH_PER, in lockstep (INT32_MIN past nq), with the fixed steps
    pos += t[pos + step - 1] < v ? step : 0 for step = P/2 .. 1 over the
    table padded to P, the power of two >= n + 1, with +inf. Asserts that
    every query is searched once and that a query past nq sits at 0."""
    n, nq = table.shape[0], queries.shape[0]
    threads, per = probes.BSEARCH_THREADS, probes.BSEARCH_PER
    group = threads * per
    p2 = 1 << n.bit_length()
    padded = np.full(p2, np.iinfo(np.int64).max)
    padded[:n] = table
    blocks = min(-(-nq // group), sms)
    lanes = np.arange(per)[:, None] * threads + np.arange(threads)[None, :]
    found = np.full(nq, -1)
    total = 0
    for b in range(blocks):
        for start in range(b * group, nq, blocks * group):
            qi = start + lanes  # (per, threads): a thread's queries by column
            live = qi < nq
            v = np.where(live, queries[np.minimum(qi, nq - 1)],
                         np.iinfo(np.int32).min)
            pos = np.zeros(qi.shape, dtype=np.int64)
            step = p2 // 2
            while step:
                pos += np.where(padded[pos + step - 1] < v, step, 0)
                step //= 2
            assert np.all(pos[~live] == 0)
            assert np.all(found[qi[live]] == -1)
            found[qi[live]] = pos[live]
            total += int(pos.sum())
    assert np.all(found >= 0)
    return found, (total + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("case", range(len(probes.BSEARCH_EDGE_SIZES)))
def test_p4_schedule_matches_searchsorted(case):
    """The kernel's schedule gives torch.searchsorted's (side="left")
    position query by query on the edge tables (n = 1, 2, 3, 8,191,
    8,192, 8,193; runs of equal entries; queries below the minimum, above
    the maximum, equal to entries, between them), alone and with random
    queries past a round (nq not a multiple of BSEARCH_PER), and the plain
    version's sum."""
    table, edges = probes.bsearch_edge_cases()[case]
    n = table.shape[0]
    assert n == probes.BSEARCH_EDGE_SIZES[case] and np.all(np.diff(table) >= 0)
    assert n < 2 or len(np.unique(table)) < n  # runs of equal entries
    rng = np.random.default_rng(case)
    extra = rng.integers(int(table[0]) - 9, int(table[-1]) + 9, 1021)
    for queries in (edges, np.concatenate([edges, extra]).astype(np.int32)):
        assert queries.shape[0] % probes.BSEARCH_PER
        pos, total = _bsearch_schedule(table, queries)
        want = torch.searchsorted(torch.from_numpy(table),
                                  torch.from_numpy(queries), side="left")
        np.testing.assert_array_equal(pos, want.numpy())
        assert total == int(probes._bsearch_plain(
            torch.from_numpy(table), torch.from_numpy(queries))[0])
    below = queries < table[0]
    assert np.all(pos[below] == 0) and np.all(pos[queries > table[-1]] == n)


def test_p4_schedule_on_many_blocks():
    """Past one round of one block per SM (a grid-stride loop) at the
    probe table: every query once, positions as torch.searchsorted."""
    table = probes.probe_inputs()["table"]
    queries = np.random.default_rng(5).integers(
        0, 1 << 30, 132 * 512 * 2 + 7).astype(np.int32)
    pos, total = _bsearch_schedule(table, queries)
    np.testing.assert_array_equal(pos, np.searchsorted(table, queries))
    assert total == int(probes._bsearch_plain(
        torch.from_numpy(table), torch.from_numpy(queries))[0])


def test_p4_schedule_matches_pallas(interpret, capsys):
    """The kernel's schedule at the script's inputs gives the interpreted
    TPU probe's sum bitwise."""
    probe_mosaic.probe_scalar_bsearch()
    _no_fail(capsys)
    (calls,) = interpret
    a = probes.probe_inputs()
    _, total = _bsearch_schedule(a["table"], a["queries"])
    for out in calls:  # the first call and the timed ones
        np.testing.assert_array_equal(np.array([total], dtype=np.int32), out)


def _assert_close_sums(got: np.ndarray, want: np.ndarray, terms: int,
                       q: np.ndarray):
    atol = 1e-6 * terms * float(np.abs(q).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def test_p3_dyn_sublane(interpret, capsys, port):
    probe_mosaic.probe_dyn_sublane()
    _no_fail(capsys)
    (calls,) = interpret
    a = probes.probe_inputs()
    terms = 2 * int(np.bincount(a["row"]).max())
    for out in calls:  # the first call and the timed ones
        _assert_close_sums(port["P3"].numpy(), out, terms, a["q"])


def test_p4_scalar_bsearch(interpret, capsys, port):
    probe_mosaic.probe_scalar_bsearch()
    _no_fail(capsys)
    (calls,) = interpret
    np.testing.assert_array_equal(calls[0], port["P4"].numpy())
    a = probes.probe_inputs()
    assert int(port["P4"][0]) == int(np.searchsorted(
        a["table"], a["queries"], side="left").sum())


def test_p6_dyn_variants(interpret, capsys, port):
    probe_mosaic2.probe_dyn_variants()
    _no_fail(capsys)
    a = probes.probe_inputs()
    got = port["P6"]
    (ca, cb, cc) = interpret
    _assert_close_sums(got["A"].numpy(), ca[0], a["idx"].shape[0], a["q"])
    np.testing.assert_array_equal(got["B"].numpy(), cb[0])
    _assert_close_sums(got["C"].numpy(), cc[0],
                       int(np.bincount(a["row"]).max()), a["q"])


@pytest.mark.parametrize("mode", sorted(probes.DYN_MODES))
def test_dyn_rows_order_is_a_stable_bucketing(mode):
    row = torch.from_numpy(probes.probe_inputs()["row"])
    lists = probes.dyn_rows_order(row, mode)
    assert len(lists) == probes.E_ROWS
    if mode == "A":
        assert torch.equal(lists[0], torch.arange(row.shape[0]))
        assert all(len(h) == 0 for h in lists[1:])
        return
    order = np.argsort(row.numpy(), kind="stable")
    np.testing.assert_array_equal(torch.cat(lists).numpy(), order)
    for r, h in enumerate(lists):
        assert torch.all(row[h] == r) and torch.all(h[1:] > h[:-1])


def _pallas_dyn(mode: str, records) -> list[np.ndarray]:
    """Every output of the Pallas probe of `mode` run in interpret mode."""
    if mode == "P3":
        probe_mosaic.probe_dyn_sublane()
        (calls,) = records
        return calls
    probe_mosaic2.probe_dyn_variants()
    return records["ABC".index(mode)]


@pytest.mark.parametrize("mode", sorted(probes.DYN_MODES))
def test_dyn_rows_replay_equals_pallas_bitwise(interpret, capsys, mode):
    """The kernel's hit order replayed on tensors gives the interpreted
    TPU probe's output bit for bit (its first call and the timed ones).
    test_p3_dyn_sublane and test_p6_dyn_variants hold the plain index_add_
    version to the sum-order tolerance."""
    outs = _pallas_dyn(mode, interpret)
    _no_fail(capsys)
    a = probes.probe_inputs()
    q, idx, row = (torch.from_numpy(a[k]) for k in ("q", "idx", "row"))
    replay = probes._dyn_rows_replay(q, idx, row, mode).numpy()
    for out in outs:
        np.testing.assert_array_equal(replay, out)


def skewed_rows(kind: str, nh: int = 4096) -> np.ndarray:
    """Rows with long hit lists: 8 rows of ~nh/8 hits, or all in one row."""
    rng = np.random.default_rng(7)
    if kind == "eight":
        return rng.choice(np.arange(3, probes.E_ROWS, 31)[:8], nh).astype(
            np.int32)
    return np.full(nh, 200, dtype=np.int32)


@pytest.mark.parametrize("kind", ["eight", "one"])
@pytest.mark.parametrize("mode", sorted(probes.DYN_MODES))
def test_dyn_rows_replay_on_long_lists(mode, kind):
    """Hit lists far longer than the probe inputs' ~16: the replay agrees
    with the plain version within the sum-order tolerance, and in mode B
    bitwise."""
    a = probes.probe_inputs()
    row = skewed_rows(kind)
    q, idx = torch.from_numpy(a["q"]), torch.from_numpy(a["idx"])
    lists = probes.dyn_rows_order(torch.from_numpy(row), mode)
    if mode != "A":
        assert max(len(h) for h in lists) >= 450
    got = probes._dyn_rows_replay(q, idx, torch.from_numpy(row), mode)
    want = probes._dyn_rows_plain(q, idx, torch.from_numpy(row), mode)
    if mode == "B":
        assert torch.equal(got, want)
        return
    terms = probes.DYN_MODES[mode][3] * max(len(h) for h in lists)
    _assert_close_sums(got.numpy(), want.numpy(), terms, a["q"])


def test_entry_point_prints_every_probe(capsys):
    res = probes.run("variants", CPU)
    text = capsys.readouterr().out
    assert set(res) == {"P5", "P6"} and set(res["P6"]) == {"A", "B", "C"}
    assert text.count("OK") == 4 and "FAIL" not in text
    with pytest.raises(ValueError, match="unknown probe"):
        probes.run("nope", CPU)
    assert probes.main(["nope"]) == 2


def test_scratch_ladder_problems_on_a_card_limit():
    def step(n, refused=False):
        out = None if refused else torch.full((1, 1), n, dtype=torch.int32)
        return probes.ScratchStep(n, out, "refused" if refused else None)

    sizes = probes.SCRATCH_SIZES
    good = [step(n) for n in sizes[:3]] + [step(sizes[3], True)]
    limit = SM90_SMEM_OPTIN
    assert probes.scratch_ladder_problems(good, limit) == []
    # a size within the limit refused; a size past it launched
    assert probes.scratch_ladder_problems(
        good[:2] + [step(sizes[2], True)], limit)
    assert probes.scratch_ladder_problems(
        [step(n) for n in sizes[:4]] + [step(sizes[4], True)], limit)


def _one_block_smem(w, hit_buffer, keep_all, block_cap):
    """Shared memory of the one-block-per-row kernel's survivor buffer:
    every block's survivors but the last one's, plus one block of
    candidates (blocked), or the whole row (full width)."""
    blocked, c, g, _ = _selection_plan(w, hit_buffer, keep_all, block_cap)
    return 8 * (min(w, (g - 1) * c + SELECT_BLOCK) if blocked else w)


@pytest.mark.parametrize("fraction", [0.005, 0.02, 0.05, 0.2, 1.0])
def test_stage_plan_fits_shared_memory(fraction):
    """Every bucket length of the auto ladder at every k: each pass of
    kernel B fits a block's shared memory, and the one-block kernel is kept
    exactly where its survivor buffer (with the static arrays' allowance)
    fits."""
    too_big = []
    for length in (1 << p for p in range(10, 19)):
        for k in (15, 21, 31):
            config = PipelineConfig(kmer_size=k,
                                    kmer_sample_fraction=fraction)
            hit_buffer, keep_all, cap = staging_params(length, config)
            w = length - k + 1
            plan = stage_launch_plan(w, hit_buffer, keep_all, cap)
            assert all(b <= SM90_SMEM_OPTIN for _, b in plan.passes), plan
            smem = _one_block_smem(w, hit_buffer, keep_all, cap)
            assert plan.long == (smem + STATIC_SMEM > SM90_SMEM_OPTIN)
            if plan.long:
                too_big.append((length, k))
                assert plan.chunk * plan.n_chunks >= plan.n_surv
            else:
                assert plan.passes == (("select_stage_rows", smem),)
    if fraction == 0.2:
        assert {length for length, _ in too_big} == {1 << 17, 1 << 18}
    if fraction == 1.0:
        assert {length for length, _ in too_big} == {
            1 << p for p in range(15, 19)}
    if fraction <= 0.05:  # the 262,144 bucket at 5% fits one block now
        assert not too_big


@pytest.mark.parametrize("k", [15, 31])
def test_stage_plan_boundaries_off_the_power_of_two_ladder(k):
    """--length-buckets may give any length: keep_all rows stay in one
    block up to 28,928 windows, and blocked rows of 256 1024-slot blocks up
    to a cap of 109, at lengths off the power-of-two ladder."""
    for w, one_block in ((28_928, True), (28_929, False)):
        length = w + k - 1
        assert length & (length - 1)
        assert stage_launch_plan(w, w, True, None).long != one_block
    w = 262_100 - k + 1
    assert -(-w // SELECT_BLOCK) == 256
    for cap, one_block in ((109, True), (110, False)):
        plan = stage_launch_plan(w, 16_384, False, cap)
        assert plan.blocked and plan.long != one_block
