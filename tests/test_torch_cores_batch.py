"""The port's batched merger-core search (velociraptor_stf_tpu_torch/
models/substructure.py: ``search_level_cores``, ``search_cores_batch``,
``_phase_tensor_growth_batch``) against the JAX package's per-structure
search (``halo_core_search``): core ids and core counts exactly equal;
the substructure ids after promotion and the host merges
(``_cores_and_merges``), and ``subsub_cores_promoted``, equal to those of
the JAX cores.

The level holds tests/test_cores.py's merger mocks of several sizes,
some with substructure ids already set, a relaxed halo and small cold
clumps, so that it has a structure with no second core, one with three
or more, one that stops on each of the loop's two breaks before the last
loop, one that runs every loop, two cores of one size (the tie rule) and
one whose cores the ``minsize`` break decides (the fixture checks each).
The cases: with and without the host merges (``coresubmergemindist``),
level 2, no phase-tensor growth, options under which ``minsize`` grows
fast, a pair budget that splits the level into batches;
``Halo_core_loop_ellx_fac`` > 1 (a growing length) in the batch too; no
search past ``maxnlevelcoresearch`` or with cores off; the mesh route;
host waits that do not grow with the number of structures.
"""

import copy

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.ops import fof as jfof
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.parallel.distributed_substructure import \
    distributed_structure_search
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.utils import telemetry

from test_cores import G, merger_mock
from torch_threads import one_torch_thread  # noqa: F401


def _jopts(**over):
    """tests/test_cores.py's sample-config core options."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.5
    opt.iHaloCoreSearch = 2
    opt.halocorexfac = 0.7
    opt.halocorevfac = 2.0
    opt.halocorenfac = 0.005
    opt.halocorenumloops = 8
    opt.halocorexfaciter = 0.75
    opt.halocorevfaciter = 1.0
    opt.halocorenumfaciter = 1.2
    opt.MinSize = 20
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _opts(**over):
    """``_jopts`` as the port holds them."""
    return convert.options(_jopts(**over))


def _entry(g, pos, vel, mass, tagged=None):
    """A structure as ``search_sub_sub`` hands it to the core lap: its
    rows, the bounds on the host, and the subset search's ids (``tagged``
    rows in substructure 1)."""
    n = len(pos)
    sub = torch.zeros(n, dtype=torch.int64)
    if tagged is not None:
        sub[torch.from_numpy(tagged)] = 1
    p = torch.from_numpy(pos)
    b = p.double()
    return {"g": g, "ppos": p, "pvel": torch.from_numpy(vel),
            "pmass": torch.from_numpy(mass),
            "valid": torch.ones(n, dtype=torch.bool), "nsub": n,
            "npad": n, "bounds": (b.amin(0).numpy(), b.amax(0).numpy()),
            "sub": sub, "ng_sub": int(tagged is not None)}


def _jax_alone(jopt, e, level=1):
    """The JAX package's ``halo_core_search`` of ``e`` over its bounds:
    (core ids, ncores)."""
    n = e["nsub"]
    core, nc = JS.halo_core_search(
        jopt, *(e[k][:n].numpy() for k in ("ppos", "pvel", "pmass", "valid")),
        e["sub"].numpy().astype(np.int32), sublevel=level,
        bounds=e["bounds"])
    return np.asarray(core), nc


def _loops(jopt, e, level=1):
    """(core groups found in each loop, ncores) of the JAX per-structure
    search of ``e``: the loop ran as many times as groups were counted,
    and its last count is 0 where it broke for want of a core."""
    found = []
    real = jfof.renumber_by_size

    def record(*a, **k):
        out = real(*a, **k)
        found.append(int(out[1]))
        return out

    jfof.renumber_by_size = record
    try:
        _, nc = _jax_alone(jopt, e, level)
    finally:
        jfof.renumber_by_size = real
    return found, nc


@pytest.fixture(scope="module")
def level():
    """The level's structures in the order of their group ids."""
    rng = np.random.default_rng(7)
    out = []
    for g, (seed, n1, n2, tag) in enumerate(
            [(0, 2000, 1000, False), (1, 1500, 700, False),
             (3, 2500, 800, True), (2, 3000, 1500, False),
             (0, 2000, 1000, True)], 1):
        pos, vel, mass, member2 = merger_mock(seed=seed, n1=n1, n2=n2)
        tagged = member2 & (np.arange(len(pos)) % 3 == 0) if tag else None
        out.append(_entry(g, pos, vel, mass, tagged))
    n, sigma = 1500, np.sqrt(G * 100.0 / 6)
    out.append(_entry(len(out) + 1,
                      rng.normal(0, 0.25, (n, 3)).astype(np.float32),
                      rng.normal(0, sigma, (n, 3)).astype(np.float32),
                      np.full(n, 100.0 / n, np.float32)))
    for n in (70, 120):          # cold clumps: one core, loop after loop
        out.append(_entry(len(out) + 1,
                          rng.normal(0, 0.002, (n, 3)).astype(np.float32),
                          rng.normal(0, 1.0, (n, 3)).astype(np.float32),
                          np.full(n, 0.01, np.float32)))
    # twin clumps of 60, one the other moved: two cores of one size,
    # numbered by the tie rule
    one = rng.normal(0, 0.002, (60, 3))
    twin = np.concatenate([one, one + [0.3, 0, 0]])
    out.append(_entry(len(out) + 1, twin.astype(np.float32),
                      np.tile(rng.normal(0, 1.0, (60, 3)),
                              (2, 1)).astype(np.float32),
                      np.full(120, 0.01, np.float32)))
    # a ball of 65 with three members at 0.045 (linked at loop 1, not at
    # loop 2) and a clump of 12: under ``_MINSIZE``'s options its search
    # stops on ``minsize`` after loop 1, which keeps the three in core 1
    d = rng.normal(size=(3, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.concatenate([rng.normal(0, 0.001, (65, 3)), 0.045 * d,
                          [0.5, 0, 0] + rng.normal(0, 0.001, (12, 3))])
    vel = np.concatenate([rng.normal(0, 1.0, (65, 3)),
                          rng.normal(0, 0.1, (15, 3))])
    out.append(_entry(len(out) + 1, pos.astype(np.float32),
                      vel.astype(np.float32), np.full(80, 0.01, np.float32)))
    return out


# the last structure's minsize break decides its cores (no growth, which
# would hand the three back to core 1)
_MINSIZE = {"MinSize": 10, "halocorenumfaciter": 2.0, "iPhaseCoreGrowth": 0}


def test_the_level_holds_every_kind_of_structure(level):
    runs = [_loops(_jopts(), e) for e in level]
    assert any(nc == 0 for _, nc in runs)                     # no 2nd core
    assert any(nc >= 3 for _, nc in runs)
    assert any(f[-1] == 0 and len(f) < 8 for f, _ in runs)    # no core
    assert any(f[-1] > 0 and len(f) < 8 for f, _ in runs)     # minsize
    assert any(len(f) == 8 for f, _ in runs)
    assert any(e["ng_sub"] > 0 for e in level)
    assert runs[-2][0][0] == 2 and runs[-2][1] == 2
    (core, nc), = TS.search_cores_batch(_opts(), [dict(level[-2])], 1)
    assert nc == 2 and torch.equal(core, torch.arange(120) // 60 + 1)
    found, nc = _loops(_jopts(**_MINSIZE), level[-1])
    assert nc == 2 and len(found) == 2 and found[-1] > 0
    assert len({e["nsub"] for e in level}) >= 6


def _jax_cores_and_merges(opt, entries, level_no, want):
    """Each structure's promotion and host merges from the JAX cores
    ``want`` (``_jax_alone``'s)."""
    for e, (core, nc) in zip(entries, want):
        TS._cores_and_merges(opt, e, level_no,
                             (torch.tensor(core, dtype=torch.int64), nc))
    return entries


@pytest.mark.parametrize("case", ["plain", "merges", "level2", "no_growth",
                                  "minsize", "split"])
def test_batched_cores_equal_the_per_structure_search(level, case):
    over, level_no, budget = {}, 1, None
    if case == "merges":
        over = {"coresubmergemindist": 1.0}
    elif case == "level2":
        level_no = 2
    elif case == "no_growth":
        over = {"iPhaseCoreGrowth": 0}
    elif case == "minsize":
        over = _MINSIZE
    elif case == "split":
        budget = 1 << 17
    jopt = _jopts(**over)
    opt = convert.options(jopt)
    want = [_jax_alone(jopt, e, level_no) for e in level]
    batches = []
    real = TS._cores_batch

    def record(opt, cells, *a):
        batches.append(a[-4:-2])
        return real(opt, cells, *a)

    TS._cores_batch = record
    try:
        got = TS.search_cores_batch(opt, [dict(e) for e in level], level_no,
                                    pair_budget=budget)
    finally:
        TS._cores_batch = real
    assert len(batches) == 1 if budget is None else len(batches) > 1
    for (gc, gn), (wc, wn) in zip(got, want):
        assert gn == wn
        assert gc.dtype == torch.int64
        np.testing.assert_array_equal(gc.numpy(), wc)
    assert sum(wn >= 2 for _, wn in want) >= 2

    telemetry.reset()
    seq = _jax_cores_and_merges(opt, copy.deepcopy(level), level_no, want)
    promoted = telemetry.snapshot()["subsub_cores_promoted"]
    telemetry.reset()
    bat = copy.deepcopy(level)
    TS.search_level_cores(opt, bat, level_no, True)
    assert telemetry.snapshot()["subsub_cores_promoted"] == promoted > 0
    for a, b in zip(seq, bat):
        assert a["ng_sub"] == b["ng_sub"]
        assert torch.equal(a["sub"], b["sub"])


def test_a_growing_length_takes_the_per_structure_route(level):
    """``Halo_core_loop_ellx_fac`` > 1: one pair table at the last loop's
    length serves every loop, each cutting by its own, so the structures
    go through the batch and give the JAX per-structure search's ids."""
    jopt = _jopts(halocorexfaciter=1.05, halocorenumloops=3)
    opt = convert.options(jopt)
    want = [_jax_alone(jopt, e) for e in level[:3]]
    batches = []
    real = TS._cores_batch

    def record(*a):
        batches.append(a[-4:-2])
        return real(*a)

    TS._cores_batch = record
    try:
        got = TS.search_cores_batch(opt, [dict(e) for e in level[:3]], 1)
    finally:
        TS._cores_batch = real
    assert batches == [(0, 3)]
    for (gc, gn), (wc, wn) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gc.numpy(), wc)
    assert any(wn >= 2 for _, wn in want)
    seq = _jax_cores_and_merges(opt, copy.deepcopy(level[:3]), 1, want)
    bat = copy.deepcopy(level[:3])
    TS.search_level_cores(opt, bat, 1, True)
    for a, b in zip(seq, bat):
        assert a["ng_sub"] == b["ng_sub"]
        assert torch.equal(a["sub"], b["sub"])
    # no core search beyond maxnlevelcoresearch, or with cores off
    TS._cores_batch = record
    try:
        for lv, on in ((_opts().maxnlevelcoresearch + 1, True), (1, False)):
            ents = copy.deepcopy(level[:2])
            TS.search_level_cores(_opts(), ents, lv, on)
            for a, b in zip(ents, level[:2]):
                assert a["ng_sub"] == b["ng_sub"]
                assert torch.equal(a["sub"], b["sub"])
    finally:
        TS._cores_batch = real
    assert batches == [(0, 3)]


def test_the_mesh_route_batches_each_shards_structures(level):
    """``distributed_structure_search`` on four CPU shards equals one
    device, each shard's structures in one batched core search."""
    opt = _opts(iSubSearch=1, iiterflag=1, ellthreshold=2.5, Vratio=2.0,
                thetaopen=0.1)
    opt.ellxscale = 0.25
    ents = []
    for e in level:
        e = dict(e)
        e["ell"] = torch.zeros(e["nsub"])     # no outliers: no subsets
        ents.append(e)
    one = copy.deepcopy(ents)
    TS.search_subset_batch(opt, one)
    TS.search_level_cores(opt, one, 1, True)
    dealt = copy.deepcopy(ents)
    batches = []
    real = TS._cores_batch

    def record(*a):
        batches.append(a[-4:-2])
        return real(*a)

    TS._cores_batch = record
    try:
        distributed_structure_search(opt, dealt, 1, True,
                                     make_mesh(4, "cpu"))
    finally:
        TS._cores_batch = real
    # each loaded shard one batch, over all its structures
    assert len(batches) <= 4 and \
        sum(k1 - k0 for k0, k1 in batches) == len(level)
    assert sum(e["ng_sub"] for e in one) > 0
    for a, b in zip(one, dealt):
        assert a["ng_sub"] == b["ng_sub"]
        assert torch.equal(a["sub"], b["sub"])


class _HostSyncs(TorchFunctionMode):
    """Counts the calls that wait for the device and copy to the host."""

    SYNC = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
            "__float__", "__index__", "__array__", "equal", "nonzero",
            "unique", "unique_consecutive"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.SYNC:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_host_waits_do_not_grow_with_the_structures(level):
    """The level thrice in one batch waits for the host as often as the
    level once (the label fixed points run over the union), and far less
    often than its structures each searched as a batch of one."""
    opt = _opts()
    with _HostSyncs() as once:
        TS.search_cores_batch(opt, [dict(e) for e in level], 1)
    with _HostSyncs() as thrice:
        TS.search_cores_batch(opt, [dict(e) for e in level * 3], 1)
    with _HostSyncs() as alone:
        for e in level:
            TS.search_cores_batch(opt, [dict(e)], 1)
    assert thrice.n == once.n < alone.n / 2
