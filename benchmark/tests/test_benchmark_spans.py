"""The readers of the program's spans on a synthetic device trace and span
list: what each counts, which catalogs they keep, and nothing without a
trace or without the program's spans."""

import numpy as np
import pytest

from benchmark.harness import registry, runner
from benchmark.harness.trace import DeviceTrace
from benchmark.tests.tiny import REPO
from velociraptor_stf_tpu_torch.utils import timing

NS = 1_000_000_000


def rec(sid, catalog, name, t0, t1, parent=None):
    return {"id": sid, "parent": parent, "catalog": catalog, "name": name,
            "t0_ns": int(t0 * NS), "t1_ns": int(t1 * NS), "attrs": {}}


def catalog_spans(first, t0):
    """One catalog from ``t0`` (s): 4 s long, a merger-core lap in its
    second second with two structures in it."""
    c, cores = first, first + 1
    return [rec(first + 2, c, "substructure.cores.structure", t0 + 1.1,
                t0 + 1.4, cores),
            rec(first + 3, c, "substructure.cores.structure", t0 + 1.5,
                t0 + 1.9, cores),
            rec(cores, c, "substructure.cores", t0 + 1.0, t0 + 2.0, c),
            rec(c, c, "catalog", t0, t0 + 4.0)]


SPANS = (catalog_spans(1, 90.0)          # before the traced window
         + catalog_spans(11, 100.5) + catalog_spans(21, 105.0))

TRACE = DeviceTrace(
    names=["k_a", "k_b", "k_c", "k_d"],
    start=np.array([91.0, 101.5, 103.0, 106.0]),
    end=np.array([92.0, 102.0, 104.0, 106.25]),
    host_names=["cudaStreamSynchronize", "cudaLaunchKernel",
                "cudaStreamSynchronize", "cudaMemcpyAsync",
                "cudaLaunchKernel", "cudaLaunchKernel", "aten::add",
                "cudaDeviceSynchronize", "cuLaunchKernelEx",
                "cudaLaunchKernel", "cudaMemcpyAsync"],
    host_start=np.array([95.0, 101.7, 102.0, 103.0, 104.0, 106.2, 106.3,
                         106.5, 107.5, 109.5, 109.8]),
    host_end=np.array([95.1, 101.8, 102.1, 103.1, 104.1, 106.3, 106.4,
                       106.6, 107.6, 109.6, 109.9]),
    t0=100.0, t1=110.0)

WANT = {
    # waits in the two catalogs of the window: 102.0, 103.0, 106.5
    "device.waits": 1.5,
    # launches: 101.7, 104.0, 106.2, 107.5 (a driver-API launch)
    "device.launches": 2.0,
    "substructure.cores_waits": 1.0,        # 102.0, 106.5
    "substructure.cores_launches": 1.0,     # 101.7, 106.2
    # busy 0.5 s of the first lap, 0.25 s of the second
    "substructure.cores_idle_share": 100.0 * (1.0 - 0.75 / 2.0),
    "substructure.cores_structures": 2.0,
}


def ctx_of(trace, timings=()):
    win = runner.Window(walls=[1.0] * len(timings), timings=list(timings))
    return runner.Ctx(win, trace, fof_work=None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_counts_inside_its_spans(name, monkeypatch):
    monkeypatch.setattr(timing, "spans", lambda: list(SPANS))
    read = registry.metric_reader(name, REPO)
    assert read(ctx_of(TRACE)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_no_trace_or_no_span_reads_nothing(name, monkeypatch):
    read = registry.metric_reader(name, REPO)
    monkeypatch.setattr(timing, "spans", lambda: list(SPANS))
    assert read(ctx_of(None)) is None
    # no catalog span inside the window
    monkeypatch.setattr(timing, "spans", lambda: catalog_spans(1, 90.0))
    assert read(ctx_of(TRACE)) is None
    # a program that records no spans
    monkeypatch.delattr(timing, "spans")
    assert read(ctx_of(TRACE)) is None


def test_a_catalog_without_merger_cores_reads_none_of_their_work(
        monkeypatch):
    monkeypatch.setattr(timing, "spans",
                        lambda: [rec(11, 11, "catalog", 100.5, 104.5)])
    ctx = ctx_of(TRACE)
    for name in WANT:
        if name.startswith("substructure."):
            assert registry.metric_reader(name, REPO)(ctx) == 0.0, name
    assert registry.metric_reader("device.waits", REPO)(ctx) == 2.0


def test_transfer_in_is_the_mean_of_the_to_device_times():
    read = registry.metric_reader("entry.transfer_in_s", REPO)
    ctx = ctx_of(TRACE, [{"to_device": 0.1, "fof": 1.0},
                         {"to_device": 0.3, "fof": 1.0}])
    assert read(ctx) == pytest.approx(0.2)
    assert read(ctx_of(TRACE, [{"fof": 1.0}])) is None


def test_stages_breaks_a_traced_catalog_down_by_span(tmp_path):
    """``stages.py`` on a small copy of a cell on the CPU: one row a span
    name, the catalog's among them, nested spans inside their parents'
    time."""
    from benchmark import stages
    from benchmark.tests.tiny import tiny_root

    rows = {r["span"]: r for r in stages.breakdown(
        "dmcosmo.z6", 2 ** 31 + 11, "cpu", tiny_root(tmp_path))}
    assert {"catalog", "to_device", "halos.fof", "substructure",
            "substructure.cores", "substructure.cores.structure",
            "cores.fof", "properties", "so"} <= set(rows)
    assert rows["catalog"]["spans"] == 1.0
    assert rows["substructure.cores.structure"]["spans"] >= 1.0
    assert rows["cores.fof"]["seconds"] <= \
        rows["substructure.cores"]["seconds"] <= \
        rows["substructure"]["seconds"] <= rows["catalog"]["seconds"]
