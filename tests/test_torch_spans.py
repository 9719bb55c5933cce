"""The port's spans (velociraptor_stf_tpu_torch/utils/timing.py::span):
they nest with one catalog id, record only under a ``torch.profiler``
session and then on the profiler's own host clock, carry the counters
counted inside them, and ``find_structures`` records its stages, the
recursion's laps, the merger-core search's batches and one span per
structure searched.

This file imports no jax: on a card it runs with

    python -m pytest tests/test_torch_spans.py --noconftest -q

and its ``gpu`` test checks that a span holds its kernel's device time.
"""

import collections
import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from velociraptor_stf_tpu_torch.io.synthetic import G_KMS, planted_subhalos
from velociraptor_stf_tpu_torch.models import pipeline
from velociraptor_stf_tpu_torch.utils import config as C
from velociraptor_stf_tpu_torch.utils import telemetry, timing

from torch_threads import one_torch_thread  # noqa: F401

STAGES = ("to_device", "halos.fof", "unbind", "substructure", "properties")
LAPS = ("density", "prep", "outliers", "subset", "cores", "unbind",
        "splice")


def _options():
    """Substructure with merger cores on two planted hosts (the case of
    tests/test_torch_import.py)."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.iSubSearch, opt.iiterflag, opt.iHaloCoreSearch = 1, 1, 2
    opt.uinfo.unbindflag, opt.iBoundHalos, opt.G = 1, 2, G_KMS
    C.config_check(opt)
    return opt


@pytest.fixture(scope="module")
def catalogs():
    """One catalog with no profiler, then one under a CPU profiler: the
    results and the spans each recorded."""
    pos, vel, mass, _ = planted_subhalos(2, seed=3, offset=4.0)
    opt = _options()
    timing.clear_spans()
    plain = pipeline.find_structures(copy.deepcopy(opt), pos, vel, mass,
                                     boxsize=12.0, device="cpu")
    quiet = timing.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = pipeline.find_structures(copy.deepcopy(opt), pos, vel,
                                          mass, boxsize=12.0, device="cpu")
    recs = timing.spans()
    timing.clear_spans()
    return plain, quiet, traced, recs


def test_spans_nest_with_their_parent_and_one_catalog_id():
    timing.clear_spans()
    times = {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with timing.span("outer", times, "outer", n=3):
                with timing.span("middle") as mid:
                    mid.set(late=1)
                    with timing.span("inner"):
                        telemetry.count("spans_test_key", 2)
                        telemetry.count("spans_test_key")
                    telemetry.count("spans_test_other")
    recs = timing.spans()
    timing.clear_spans()
    assert [r["name"] for r in recs] == ["inner", "middle", "outer"] * 2
    by = {r["id"]: r for r in recs}
    for inner, middle, outer in (recs[:3], recs[3:]):
        assert outer["parent"] is None and outer["catalog"] == outer["id"]
        assert middle["parent"] == outer["id"]
        assert inner["parent"] == middle["id"]
        assert inner["catalog"] == middle["catalog"] == outer["id"]
        assert outer["t0_ns"] <= middle["t0_ns"] <= inner["t0_ns"] <= \
            inner["t1_ns"] <= middle["t1_ns"] <= outer["t1_ns"]
        assert outer["attrs"] == {"n": 3}
        assert middle["attrs"] == {"late": 1,
                                   "counts": {"spans_test_other": 1}}
        assert inner["attrs"] == {"counts": {"spans_test_key": 3}}
    assert recs[2]["catalog"] != recs[5]["catalog"] and len(by) == 6
    assert set(times) == {"outer"} and times["outer"] > 0.0


def test_the_buffer_drops_its_oldest_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(timing, "_SPANS", collections.deque(maxlen=3))
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with timing.span(f"s{k}"):
                pass
    assert [r["name"] for r in timing.spans()] == ["s2", "s3", "s4"]
    assert timing.dropped_spans() == 2
    timing.clear_spans()
    assert timing.spans() == [] and timing.dropped_spans() == 0


def test_nothing_records_without_a_profiler(catalogs):
    plain, quiet, traced, _ = catalogs
    assert quiet == [] and not timing.recording()
    assert timing.span("fine") is timing.span("other", level=2)
    times = {}
    with timing.span("stage", times, "stage", device=torch.device("cpu")):
        pass
    assert set(times) == {"stage"} and timing.spans() == []
    stages = {"to_device", "fof", "unbind", "substructure", "properties"} | \
        {f"subsub_{p}" for p in LAPS}
    assert set(plain.timings) == set(traced.timings) == stages
    assert all(v >= 0.0 for v in plain.timings.values())


def test_search_and_unbind_keeps_its_stage_keys():
    pos, vel, mass, _ = planted_subhalos(1, seed=5, offset=4.0)
    opt = _options()
    opt.iSubSearch = 0
    res = pipeline.search_and_unbind(opt, pos, vel, mass, boxsize=8.0,
                                     device="cpu")
    assert set(res.timings) == {"fof", "unbind"}


def test_span_times_are_the_profilers_clock():
    """Each span's ends lie within 1 ms of its own range's in the
    profiler's events, as the profiler stamps them."""
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(4):
            with timing.span(f"clock_probe_{k}"):
                torch.ones(1 << 16).cumsum(0)
    recs = {r["name"]: r for r in timing.spans()}
    timing.clear_spans()
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("clock_probe_")}
    assert set(events) == set(recs)
    for name, r in recs.items():
        ev = events[name]
        assert abs(ev.start_ns() - r["t0_ns"]) < 1_000_000, name
        assert abs(ev.start_ns() + ev.duration_ns() - r["t1_ns"]) < \
            1_000_000, name


def test_find_structures_records_its_tree(catalogs):
    plain, _, traced, recs = catalogs
    assert traced.ngroups == plain.ngroups and (traced.pfof ==
                                                plain.pfof).all()
    names = collections.Counter(r["name"] for r in recs)
    (root,) = [r for r in recs if r["name"] == "catalog"]
    assert root["attrs"]["particles"] == len(plain.pfof)
    assert {r["catalog"] for r in recs} == {root["id"]}
    for s in STAGES:
        assert names[s] >= 1, s
    # the entry's copies and the hydro fields' copy at the properties
    assert names["to_device"] == 2
    # the field unbind and Bound_halos = 2's re-unbind
    assert names["unbind"] == 2
    assert names["substructure.density"] == 1
    for p in LAPS[1:]:
        assert names[f"substructure.{p}"] == names["substructure.level"], p
    by = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] in ("substructure.level", "substructure.density"):
            assert by[r["parent"]]["name"] == "substructure"
        if r["name"] == "substructure.cores.structure":
            assert by[r["parent"]]["name"] == "substructure.cores"
            assert set(r["attrs"]) >= {"g", "nsub", "level"}
        # the level's core search runs batched: one cores.fof and at most
        # one cores.growth a batch; the host merges stay per structure
        if r["name"] == "cores.batch":
            assert by[r["parent"]]["name"] == "substructure.cores"
            assert set(r["attrs"]) >= {"structures", "rows", "loops",
                                       "sweeps"}
        if r["name"] in ("cores.fof", "cores.growth"):
            assert by[r["parent"]]["name"] == "cores.batch"
        if r["name"] == "cores.merge":
            assert by[r["parent"]]["name"] == \
                "substructure.cores.structure"
    assert names["cores.fof"] == names["cores.batch"] >= 1
    assert names["cores.growth"] <= names["cores.batch"]
    assert sum(r["attrs"]["structures"] for r in recs
               if r["name"] == "cores.batch") == \
        names["substructure.cores.structure"]
    # one structure span per structure searched at a core-search level
    searched = 0
    for r in recs:
        for k, v in r["attrs"].get("counts", {}).items():
            if k.startswith("subsub_level") and k.endswith("_structures"):
                level = int(k[len("subsub_level"):-len("_structures")])
                if level <= _options().maxnlevelcoresearch:
                    searched += v
    levels = [r["attrs"] for r in recs if r["name"] == "substructure.level"]
    assert searched == sum(a["structures"] for a in levels) > 0
    assert names["substructure.cores.structure"] == searched
    # the laps' spans hold the laps' times
    for p in LAPS:
        dur = sum(r["t1_ns"] - r["t0_ns"] for r in recs
                  if r["name"] == f"substructure.{p}") * 1e-9
        assert abs(dur - traced.timings[f"subsub_{p}"]) < 1e-3, p


def test_recording_changes_no_catalog(catalogs):
    """Recording changes no catalog: the profiled catalog equals the
    plain one in ids, hierarchy and properties."""
    plain, _, traced, _ = catalogs
    assert (traced.parent == plain.parent).all()
    for k, v in plain.props.items():
        assert torch.equal(torch.as_tensor(traced.props[k]),
                           torch.as_tensor(v)), k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_span_holds_its_kernels_device_time(cuda):
    """A stage span around known kernels on the card holds each one's
    device interval, on the profiler's clock, within 1 ms, and its own
    range stays on the host: the card's timeline holds no copy of it."""
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    timing.clear_spans()
    times = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with timing.span("gpu_probe", times, "gpu_probe", device=cuda):
            for _ in range(3):
                x = torch.sort(x, dim=1).values
    (r,) = timing.spans()
    timing.clear_spans()
    events = prof.profiler.kineto_results.events()
    # the span's own range, stamped on the host with the card traced too
    (own,) = [ev for ev in events if ev.name() == "gpu_probe"]
    assert own.device_type() == torch.autograd.DeviceType.CPU
    assert abs(own.start_ns() - r["t0_ns"]) < 1_000_000
    assert abs(own.start_ns() + own.duration_ns() - r["t1_ns"]) < 1_000_000
    kernels = [ev for ev in events
               if ev.device_type() == torch.autograd.DeviceType.CUDA and
               "sort" in ev.name().lower()]
    assert kernels
    for ev in kernels:
        assert ev.start_ns() >= r["t0_ns"] - 1_000_000
        assert ev.start_ns() + ev.duration_ns() <= r["t1_ns"] + 1_000_000
    assert times["gpu_probe"] > 0.0
