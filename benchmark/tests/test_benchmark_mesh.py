"""Cells on several cards, on the CPU: a cell of ``chips`` 2 runs over a
mesh of two CPU shards and gives the one-card catalog; a cell of one card
calls ``find_structures`` with no mesh; the device trace is taken card
by card (synthetic event lists), and on one card reads as it always has;
a machine with fewer cards than the cell asks for gets no result."""

import contextlib
import io
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import faults
from benchmark.harness import registry, runner
from benchmark.harness.trace import WINDOW, DeviceTrace, reduce_profile
from benchmark.reference import checks
from benchmark.tests.test_benchmark_spans import SPANS, ctx_of
from benchmark.tests.tiny import tiny_root
from velociraptor_stf_tpu_torch.models import pipeline
from velociraptor_stf_tpu_torch.utils import timing

CELL = "dmcosmo.z6"
SEED = 2 ** 31 + 99


def recorded_run(root, fault=None):
    """One run of CELL on the CPU: its exit code, result line, the keyword
    arguments of every ``find_structures`` call and the catalog
    compared."""
    calls, compared = [], []
    real_fs, real_cmp = pipeline.find_structures, checks.compare

    def find_structures(*a, **kw):
        calls.append(kw)
        return real_fs(*a, **kw)

    def compare(snap, prm, cand, device=None):
        compared.append(cand)
        return real_cmp(snap, prm, cand, device=device)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(pipeline, "find_structures", find_structures)
        mp.setattr(checks, "compare", compare)
        if fault is not None:
            faults.PATCHES[fault](mp.setattr)
        rc = runner.run(CELL, SEED, 0.5, False, time.perf_counter(),
                        root=root, device="cpu")
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    return rc, res, calls, compared[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    roots = {c: tiny_root(tmp_path_factory.mktemp(f"chips{c}"), chips=c)
             for c in (1, 2)}
    return roots, {c: recorded_run(r) for c, r in roots.items()}


def test_one_card_calls_find_structures_without_a_mesh(runs):
    rc, res, calls, _ = runs[1][1]
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert calls and all("mesh" not in kw for kw in calls)
    assert res["device"]["count"] == 1
    assert res["device"]["memory_peak_bytes_per_card"] == [0]


def test_two_cards_run_over_two_shards_and_give_the_one_card_catalog(runs):
    rc, res, calls, got = runs[1][2]
    assert rc == 0 and res["correct"] is True, res["checks"]
    # warm-up and every window catalog over the mesh of the cell's cards
    assert len(calls) == res["attempted"] + 1
    for kw in calls:
        assert kw["mesh"].devices == (torch.device("cpu"),) * 2
    dev = res["device"]
    assert dev["count"] == 2 and dev["kinds"] == ["cpu", "cpu"]
    assert dev["memory_peak_bytes_per_card"] == [0, 0]
    want = runs[1][1][3]
    assert got.ngroups == want.ngroups > 0
    for k in ("pfof", "parent", "hostid"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert (want.parent > 0).any()


def test_an_exchange_left_out_makes_the_two_card_run_not_correct(runs):
    rc, res, _, _ = recorded_run(runs[0][2], fault="exchange_left_out")
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["fof3d_wrong"]["value"] > 0


def test_fewer_cards_than_the_cell_asks_for_give_no_result(runs, monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = runner.run(CELL, SEED, 0.5, False, time.perf_counter(),
                    root=runs[0][2], device="cuda")
    assert rc != 0 and capsys.readouterr().out.strip() == ""


# One card: an event list whose numbers the parent of the per-card trace
# read; the same numbers come out, with or without card indices.
ONE = dict(
    names=["k_a", "k_b", "k_a", "k_c", "k_b", "k_d"],
    start=np.array([99.5, 101.2, 101.6, 103.0, 106.0, 109.0]),
    end=np.array([100.4, 101.8, 102.3, 104.5, 106.25, 110.5]),
    host_names=["find_structures", "cudaStreamSynchronize",
                "cudaLaunchKernel", "aten::nonzero",
                "cudaStreamSynchronize", "cudaLaunchKernel"],
    host_start=np.array([100.0, 102.5, 101.1, 104.6, 106.5, 107.5]),
    host_end=np.array([110.0, 102.9, 101.15, 105.9, 106.6, 107.55]),
    t0=100.0, t1=110.0)
ONE_READS = {
    "device.idle_share": 57.49999999999999,
    "substructure.cores_idle_share": 47.50000000000014,
    "device.waits": 1.0, "device.launches": 1.0,
    "substructure.cores_waits": 1.0, "substructure.cores_launches": 0.0,
}
ONE_GAPS = [("find_structures", 2.75), ("aten::nonzero", 1.5),
            ("find_structures", 0.7999999999999972),
            ("cudaStreamSynchronize", 0.7000000000000028)]
ONE_OPS = [("k_a", 1.6000000000000085), ("k_c", 1.5), ("k_d", 1.5),
           ("k_b", 0.8499999999999943)]


@pytest.mark.parametrize("card", [None, np.zeros(6, np.int64)])
def test_one_card_reads_as_before(card, monkeypatch):
    monkeypatch.setattr(timing, "spans", lambda: list(SPANS))
    tr = DeviceTrace(**ONE, card=card)
    assert tr.busy_s() == 4.25 and tr.busy_per_card() == [4.25]
    assert tr.window_s() == 10.0
    assert tr.idle_gaps(10) == ONE_GAPS and tr.top_ops(10) == ONE_OPS
    for name, want in ONE_READS.items():
        assert registry.metric_reader(name)(ctx_of(tr)) == want, name


# Two cards: card 0 busy over [101, 104] and [109.5, 110] (3.5 s of the
# 10 s window), card 1 over [105.5, 106.5] (1 s); the union of both would
# read 4.5 s busy, 55% idle, which is no card's idle share.
TWO = DeviceTrace(
    names=["k_a", "k_b", "k_c", "k_d"],
    start=np.array([101.0, 102.0, 109.5, 105.5]),
    end=np.array([103.0, 104.0, 111.0, 106.5]),
    card=np.array([0, 0, 0, 1]), cards=2,
    host_names=["find_structures"], host_start=np.array([99.0]),
    host_end=np.array([111.0]), t0=100.0, t1=110.0)


def test_two_cards_are_busy_and_idle_card_by_card(monkeypatch):
    assert TWO.busy_per_card() == [3.5, 1.0]
    assert TWO.busy_s() == 2.25
    idle = [100.0 * (1.0 - b / 10.0) for b in (3.5, 1.0)]   # 65%, 90%
    read = registry.metric_reader("device.idle_share")
    assert read(ctx_of(TWO)) == pytest.approx(sum(idle) / 2)
    # the merger-core laps [101.5, 102.5] and [106, 107]: card 0 busy 1 s
    # of their 2 s, card 1 0.5 s
    monkeypatch.setattr(timing, "spans", lambda: list(SPANS))
    read = registry.metric_reader("substructure.cores_idle_share")
    assert read(ctx_of(TWO)) == pytest.approx((50.0 + 75.0) / 2)
    assert TWO.idle_gaps(3) == [("card 0: find_structures", 5.5),
                                ("card 1: find_structures", 5.5),
                                ("card 1: find_structures", 3.5)]


def test_a_card_that_ran_nothing_is_idle_the_whole_window():
    tr = DeviceTrace(**dict(ONE, card=np.zeros(6, np.int64), cards=2))
    assert tr.busy_per_card() == [4.25, 0.0]
    assert ("card 1: no device operation", 10.0) in tr.idle_gaps(10)


class Event:
    """The part of a kineto event that the trace reads."""

    def __init__(self, name, kind, t0, t1, index=-1):
        self._v = (name, kind, index, int(t0 * 1e9), int((t1 - t0) * 1e9))

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def device_index(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def test_the_profile_keeps_each_operation_s_card():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [Event(WINDOW, cpu, 100.0, 110.0),
              Event("find_structures", cpu, 99.0, 111.0),
              Event("k_a", cuda, 101.0, 103.0, 0),
              Event("k_b", cuda, 102.0, 104.0, 0),
              Event("k_c", cuda, 109.5, 111.0, 0),
              Event("k_d", cuda, 105.5, 106.5, 1)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = reduce_profile(prof, cards=2)
    assert (tr.t0, tr.t1) == (100.0, 110.0)
    assert tr.card.tolist() == [0, 0, 0, 1] and tr.cards == 2
    assert tr.host_names == ["find_structures"]
    assert tr.busy_per_card() == pytest.approx([3.5, 1.0])
    one = reduce_profile(prof)
    assert one.busy_per_card() == pytest.approx([4.5])
