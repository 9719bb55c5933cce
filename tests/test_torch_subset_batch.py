"""The port's batched subset search (velociraptor_stf_tpu_torch/models/
substructure.py::search_subset_batch and the mesh form in
parallel/distributed_substructure.py) against the JAX package's
class-batched search (``_search_subset_batch``) and its per-structure
``search_subset``: ids and group counts exactly equal.

* the three structures of tests/test_distributed.py:348-392 for every
  foftype the JAX package batches;
* one batch of structures of three pad sizes: one without any group, and
  one whose two first-pass groups merge under fmerge;
* a pair budget small enough to split the structures into batches;
* the recursion sends every structure through the batch, also for
  FOFSTPROBNNNODIST and iiterflag = 0, with the JAX package's ids;
* the host fetches: one for the candidate totals, then at most two per
  batch (``utils/transfer.py::fetch_small``), and no more host syncs for nine
  structures in a batch than for three;
* the mesh: the structures dealt to eight CPU shards, each running one
  batched search, equal to one device bit for bit.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS,
                                                     host_with_subhalo,
                                                     planted_subhalos)
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.ops import segments as tseg
from velociraptor_stf_tpu_torch.parallel.distributed_substructure import \
    distributed_structure_search
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401

BATCHABLE = [C.FOFSTPROB, C.FOFSTNOSUBSET, C.FOF6DSUBSET, C.FOFSTPROBNN,
             C.FOFSTPROBLX, C.FOFSTPROBNNLX, C.FOFSTPROBSCALEELL,
             C.FOFSTPROBSCALEELLNN]


def _opts(**over):
    """tests/test_distributed.py's substructure options."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.25
    opt.iiterflag = 1
    opt.ellthreshold, opt.Vratio, opt.thetaopen, opt.ellfac = \
        2.5, 2.0, 0.10, 1.0
    opt.MinSize = 20
    opt.G = G_KMS
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _entry(ppos, pvel, pmass, valid, ell, nsub):
    """A structure as ``search_sub_sub`` hands it over: padded rows, the
    first ``nsub`` valid, and the padded bounds on the host."""
    ppos, pvel, pmass, valid, ell = (torch.from_numpy(np.array(a)) for a in
                                     (ppos, pvel, pmass, valid, ell))
    b = ppos.double()
    return {"ppos": ppos, "pvel": pvel, "pmass": pmass, "valid": valid,
            "ell": ell, "nsub": nsub, "npad": int(ppos.shape[0]),
            "bounds": (b.amin(0).numpy(), b.amax(0).numpy())}


def _jax_entry(e):
    return {k: e[k].numpy() for k in ("ppos", "pvel", "pmass", "valid",
                                      "ell")} | {"npad": e["npad"]}


@pytest.fixture(scope="module")
def three():
    """tests/test_distributed.py:348-392: three hosts with a cold clump
    each, padded to one pad size, with the JAX package's outlier
    values."""
    rng = np.random.default_rng(5)
    opt = _opts()
    pad_spacing = 3.0 * opt.ellxscale * opt.ellphys
    out = []
    for _ in range(3):
        nhost, nsub = 2500, 350
        r = rng.uniform(size=nhost) ** 0.5
        d = rng.normal(size=(nhost, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        hpos = r[:, None] * d
        sigma = np.sqrt(G_KMS * 100.0 / 6)
        hvel = rng.normal(0, sigma, (nhost, 3))
        spos = np.array([0.4, 0, 0]) + 0.05 * rng.normal(size=(nsub, 3))
        svel = np.array([0, 1.6 * sigma, 0]) + rng.normal(0, 5, (nsub, 3))
        pos = np.concatenate([hpos, spos]).astype(np.float32)
        vel = np.concatenate([hvel, svel]).astype(np.float32)
        mass = np.full(len(pos), 100.0 / len(pos), np.float32)
        npad = JS._next_pow2(len(pos))
        ppos, pvel, pmass, valid = JS._pad_structure(pos, vel, mass, npad,
                                                     pad_spacing)
        ell, _, _ = JS.structure_outliers(opt, ppos, pvel, pmass, valid)
        out.append(_entry(ppos, pvel, pmass, valid, ell, len(pos)))
    return out


def _copies(entries):
    return [dict(e) for e in entries]


def _jax_alone(opt, entries):
    """The JAX package's per-structure ``search_subset`` of each entry's
    padded rows over its padded bounds, as entries: ``sub`` its valid
    rows' ids, ``ng_sub``."""
    out = []
    for e in entries:
        pfof, ng = JS.search_subset(
            opt, *(jnp.asarray(e[k].numpy())
                   for k in ("ppos", "pvel", "pmass", "ell")),
            bounds=e["bounds"])
        out.append({"sub": torch.from_numpy(
            np.asarray(pfof)[:e["nsub"]].astype(np.int64)), "ng_sub": ng})
    return out


@pytest.fixture(scope="module")
def three_alone(three):
    """``_jax_alone`` of ``three``, once per foftype."""
    done: dict = {}

    def get(foftype=C.FOFSTPROB):
        if foftype not in done:
            done[foftype] = _jax_alone(_opts(foftype=foftype), three)
        return done[foftype]
    return get


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g["ng_sub"] == w["ng_sub"]
        assert g["sub"].dtype == torch.int64
        assert torch.equal(g["sub"], w["sub"])


def _assert_jax_same(got, jentries):
    for g, j in zip(got, jentries):
        assert j["ng_sub"] == g["ng_sub"]
        np.testing.assert_array_equal(
            g["sub"].numpy(), np.asarray(j["sub_np"])[:g["nsub"]])


@pytest.mark.parametrize("foftype", BATCHABLE)
def test_batch_matches_reference_and_per_structure(three, three_alone,
                                                   foftype):
    opt = _opts(foftype=foftype)
    topt = convert.options(opt)
    jentries = [_jax_entry(e) for e in three]
    JS._search_subset_batch(opt, jentries)
    telemetry.reset()
    got = _copies(three)
    TS.search_subset_batch(topt, got)
    assert telemetry.snapshot()["subset_batches"] == 1
    _assert_same(got, three_alone(foftype))
    _assert_jax_same(got, jentries)
    assert sum(e["ng_sub"] for e in got) > 0


def _prepared(pos, vel, mass, opt):
    """``pos`` as one structure through the port's padded context."""
    n = len(pos)
    npad = TS._next_pow2(n)
    side = int(np.ceil(max(npad - n, 1) ** (1 / 3)))
    spacing = 3.0 * opt.ellxscale * opt.ellphys * max(1.0, opt.ellxfac)
    _, ppos, pvel, pmass, valid, _ = TS._prep_class(
        *(torch.from_numpy(a) for a in (pos, vel, mass)), None,
        torch.arange(n), torch.tensor([0]), torch.tensor([n]),
        torch.tensor([side]), npad, 0.0, spacing, False)
    ell, _, _ = TS.structure_outliers(opt, ppos[0], pvel[0], pmass[0],
                                      valid[0])
    return _entry(ppos[0], pvel[0], pmass[0], valid[0], ell, n)


def _twin_clumps(seed=2, angle_deg=14.0):
    """A host whose subhalo has a twin at its place, moving in a
    direction ``angle_deg`` apart: FOF6DSUBSET's 6D first pass keeps the
    two apart, the stream criterion of the link merge joins them."""
    rng = np.random.default_rng(seed)
    pos, vel, mass, mem = host_with_subhalo(seed=seed, nhost=3000, nsub=300)
    a = np.deg2rad(angle_deg)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    p2 = pos[mem] + rng.normal(0, 0.01, (mem.sum(), 3)).astype(np.float32)
    v2 = (vel[mem] @ rot.T).astype(np.float32)
    pos = np.concatenate([pos, p2])
    vel = np.concatenate([vel, v2])
    return pos, vel, np.full(len(pos), mass[0], np.float32)


def test_mixed_batch(monkeypatch):
    """One batch of four structures of three pad sizes (1024, 4096,
    8192): a smooth host with no group, two hosts with a subhalo, and the
    twin clumps, whose two first-pass groups merge under fmerge."""
    opt = _opts(foftype=C.FOF6DSUBSET, ellvel=0.2)
    topt = convert.options(opt)
    smooth = host_with_subhalo(seed=7, nhost=900, nsub=0)[:3]
    cases = [smooth, _twin_clumps(),
             host_with_subhalo(seed=3, nhost=3500, nsub=400)[:3],
             host_with_subhalo(seed=4, nhost=5000, nsub=600)[:3]]
    entries = [_prepared(*c, topt) for c in cases]
    assert [e["npad"] for e in entries] == [1024, 4096, 4096, 8192]
    merged = []
    real = TS._merge_targets

    def spy(*args):
        t = real(*args)
        merged.append(int((t != np.arange(len(t))).sum()))
        return t

    monkeypatch.setattr(TS, "_merge_targets", spy)
    telemetry.reset()
    got = _copies(entries)
    TS.search_subset_batch(topt, got)
    assert telemetry.snapshot()["subset_batches"] == 1
    assert merged and merged[0] >= 1            # fmerge merged two groups
    _assert_same(got, _jax_alone(opt, entries))
    assert got[0]["ng_sub"] == 0 and got[1]["ng_sub"] >= 1
    assert all(e["ng_sub"] >= 1 for e in got[2:])
    # the JAX batch takes one pad size a call
    for npad in (1024, 4096, 8192):
        idx = [k for k, e in enumerate(entries) if e["npad"] == npad]
        jentries = [_jax_entry(entries[k]) for k in idx]
        JS._search_subset_batch(opt, jentries)
        _assert_jax_same([got[k] for k in idx], jentries)


@pytest.mark.parametrize("budget", [1, 800_000])
def test_pair_budget_splits_batches(three, three_alone, budget):
    """A budget under one structure's candidates puts each structure in a
    batch of its own; one over two structures' but under three's makes
    two batches.  The ids are the JAX per-structure search's."""
    topt = convert.options(_opts())
    telemetry.reset()
    got = _copies(three)
    TS.search_subset_batch(topt, got, pair_budget=budget)
    nbatch = telemetry.snapshot()["subset_batches"]
    assert nbatch == (3 if budget == 1 else 2)
    _assert_same(got, three_alone())


@pytest.mark.parametrize("case", ["batched", "nodist", "noniterative"])
def test_counters_batched_and_sequential(case):
    """search_sub_sub sends every structure through the batched search,
    whatever the foftype and ``iiterflag`` (the JAX package searches
    FOFSTPROBNNNODIST and iiterflag = 0 structure by structure,
    tests/test_substructure.py:436-477), and gives the JAX package's
    ids."""
    pos, vel, mass, host = planted_subhalos(3, seed=20)
    over = {"batched": {}, "nodist": {"foftype": C.FOFSTPROBNNNODIST},
            "noniterative": {"iiterflag": 0}}[case]
    opt = _opts(**over)
    opt.uinfo.unbindflag = 0
    topt = convert.options(opt)
    telemetry.reset()
    out = TS.search_sub_sub(topt, pos, vel, mass, host.copy(), 3)
    snap = telemetry.snapshot()
    searched = sum(v for k, v in snap.items()
                   if k.startswith("subsub_level") and
                   k.endswith("_structures"))
    assert searched >= 3
    assert snap["subset_batched_particles"] >= searched * 1024
    assert snap["subset_batches"] >= 1 and snap["subset_batch_pairs"] > 0
    want = JS.search_sub_sub(opt, pos, vel, mass, host.copy(), 3)
    assert out[1] == want[1]
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(out[3], want[3])
    if case == "batched":
        assert out[1] > 3


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
        bool_index = name == "__getitem__" and len(args) > 1 and \
            isinstance(args[1], torch.Tensor) and \
            args[1].dtype == torch.bool
        self.n += name in self.SYNC or bool_index
        return func(*args, **(kwargs or {}))


def test_host_fetches_per_batch(three, monkeypatch):
    """One audited fetch for the candidate totals, then two a batch that
    finds a group (the link-pair tables, the group counts); a batch of
    nine structures waits for the host no more often than a batch of
    three (their candidates stay within one ``cell_pairs`` chunk)."""
    topt = convert.options(_opts())
    fetched = []
    real = TS.fetch_small

    def count(x):
        fetched.append(1)
        return real(x)

    monkeypatch.setattr(TS, "fetch_small", count)
    once = _copies(three)
    with _HostSyncs() as s3:
        TS.search_subset_batch(topt, once, pair_budget=1 << 40)
    assert len(fetched) == 1 + 2
    nine = _copies(three * 3)
    fetched.clear()
    with _HostSyncs() as s9:
        TS.search_subset_batch(topt, nine, pair_budget=1 << 40)
    assert len(fetched) == 1 + 2
    assert s9.n == s3.n
    for k, e in enumerate(nine):
        assert e["ng_sub"] == once[k % 3]["ng_sub"]
        assert torch.equal(e["sub"], once[k % 3]["sub"])


def test_mesh_batched_search_matches_one_device(three):
    """The structures dealt to eight CPU shards (five idle), each shard
    one batched search over its own: the ids of one device's batched
    search, bit for bit."""
    topt = convert.options(_opts())
    one = _copies(three)
    TS.search_subset_batch(topt, one)
    telemetry.reset()
    dealt = _copies(three)
    distributed_structure_search(topt, dealt, 1, False, make_mesh(8, "cpu"))
    snap = telemetry.snapshot()
    assert snap["subset_batched_particles"] == sum(e["npad"] for e in three)
    assert snap["subset_batches"] == 3             # one a loaded shard
    _assert_same(dealt, one)


def test_structure_keyed_pair_counts():
    """pair_counts with a structure key: the distinct (key, i, j) in
    lexicographic order with their counts, against a dict."""
    rng = np.random.default_rng(3)
    m = 4000
    key = rng.integers(0, 5, m)
    gi, gj = rng.integers(0, 7, m), rng.integers(0, 7, m)
    mask = rng.random(m) < 0.7
    k, i, j, c = (t.numpy() for t in tseg.pair_counts(
        *(torch.from_numpy(a) for a in (gi, gj, mask, key))))
    want = {}
    for t in np.nonzero(mask)[0]:
        trip = (key[t], gi[t], gj[t])
        want[trip] = want.get(trip, 0) + 1
    assert list(zip(k, i, j)) == sorted(want)
    assert list(c) == [want[t] for t in sorted(want)]


def test_renumber_segments_per_segment_order():
    """Ids by (segment, decreasing size, lower tie); local ids restart in
    every segment; ineligible items get 0."""
    key = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2])
    size = torch.tensor([5, 9, 5, 3, 4, 1, 8, 8])
    tie = torch.tensor([4, 0, 2, 7, 1, 0, 6, 5])
    elig = size >= 2
    gid, local, counts = tseg.renumber_segments(key, size, tie, elig, 4)
    assert gid.tolist() == [3, 1, 2, 5, 4, 0, 7, 6]
    assert local.tolist() == [3, 1, 2, 2, 1, 0, 2, 1]
    assert counts.tolist() == [3, 2, 2, 0]
