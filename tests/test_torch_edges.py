"""The port's pair (edge) pipeline (velociraptor_stf_tpu_torch/ops/fof.py)
against the JAX package's ops/fof.py on the same numpy inputs, against the
port's own sweep path and against the float64 oracles.

Exact throughout: pair sets (as sorted (min, max) pairs of original
indices without self pairs; the order of the edges may differ), group ids,
attachment labels, nearest-assignment groups; nearest distances within
rtol 1e-6 (one float32 ulp of the metric's sum).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.models import baryons as JB
from velociraptor_stf_tpu.ops import cells as jcells
from velociraptor_stf_tpu.ops import fof as JF

from velociraptor_stf_tpu_torch.models import baryons as TB
from velociraptor_stf_tpu_torch.ops import fof as TF
from velociraptor_stf_tpu_torch.ops.fof_sweep import SweepFof
from velociraptor_stf_tpu_torch.validation import oracles
from torch_threads import one_torch_thread  # noqa: F401

BOX = 10.0


def _points(seed, n=1500, nblob=5):
    """Uniform points with tight blobs, two of them on faces of the box."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    centres = rng.uniform(2, 8, (nblob, 3))
    centres[0, 0] = 0.02
    centres[1] = (BOX - 0.03, 0.01, 5.0)
    for c in centres:
        m = rng.integers(0, n, 120)
        pos[m] = c + rng.normal(0, 0.08, (len(m), 3))
    pos = np.mod(pos, BOX).astype(np.float32)
    vel = rng.normal(0, 40, (n, 3)).astype(np.float32)
    return pos, vel, rng


def _pair_set(erow, ecol, order):
    """Sorted unique (min, max) original-index pairs, self pairs dropped."""
    order = np.asarray(order)
    a, b = order[np.asarray(erow)], order[np.asarray(ecol)]
    keep = a != b
    lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    return np.unique(np.stack([lo, hi], 1), axis=0)


def _predicates(name, pos, vel, rng):
    """(linking length, fields, JAX predicate, port predicate)."""
    n = len(pos)
    if name == "3d":
        return 0.3, {}, JF.Pred3D(0.09), TF.Pred3D(0.09)
    if name == "6d":
        f = {"vel": vel, "group": rng.integers(1, 3, n).astype(np.int32)}
        return 0.3, f, JF.Pred6D(0.09, 2500.0), TF.Pred6D(0.09, 2500.0)
    if name == "6dscaled":
        # pre-scaled coordinates: the unit ball is the linking length;
        # the velocity scale is its group's, so the criterion is symmetric
        group = rng.integers(1, 3, n).astype(np.int32)
        f = {"vel": vel, "group": group,
             "vscale2": np.where(group == 1, 1800.0, 3200.0).astype(
                 np.float32)}
        return 1.0, f, JF.Pred6DScaled(), TF.Pred6DScaled()
    f = {"vel": vel, "isb": (rng.random(n) < 0.3).astype(np.int32)}
    return 0.4, f, JB._PairInRange(0.16, 2500.0), \
        TB._PairInRange(0.16, 2500.0)


@pytest.mark.parametrize("periodic", [True, False],
                         ids=["periodic", "open"])
@pytest.mark.parametrize("name", ["3d", "6d", "6dscaled", "pairinrange"])
def test_build_edges_pair_sets_match_reference(name, periodic):
    pos, vel, rng = _points(3)
    ell, fields, jpred, tpred = _predicates(name, pos, vel, rng)
    scale = 0.3 if name == "6dscaled" else 1.0
    pos = pos / np.float32(scale)
    box = (BOX / scale) if periodic else None
    je, _, _ = JF.build_edges(
        jnp.asarray(pos), ell, boxsize=box,
        fields={k: jnp.asarray(v) for k, v in fields.items()},
        predicate=jpred)
    want = _pair_set(je.erow, je.ecol, je.order)
    tfields = {k: torch.from_numpy(v) for k, v in fields.items()}
    te = TF.build_edges(torch.from_numpy(pos), ell, boxsize=box,
                        fields=tfields, predicate=tpred)
    assert te.undirected and len(want) > 100
    # each pair once, in cell-sorted order, with the sorted payloads
    assert bool((te.ecol > te.erow).all())
    assert len(te.erow) == len(want)
    np.testing.assert_array_equal(_pair_set(te.erow, te.ecol, te.order),
                                  want)
    np.testing.assert_array_equal(te.pos_s.numpy(), pos[te.order.numpy()])
    for k, v in fields.items():
        np.testing.assert_array_equal(te.fields_s[k].numpy(),
                                      v[te.order.numpy()])
    # the directed form: both orientations of the same pairs, plus self
    td = TF.build_edges(torch.from_numpy(pos), ell, boxsize=box,
                        fields=tfields, predicate=tpred, half=False)
    assert not td.undirected
    np.testing.assert_array_equal(_pair_set(td.erow, td.ecol, td.order),
                                  want)
    nself = int((td.erow == td.ecol).sum())
    assert len(td.erow) == 2 * len(want) + nself
    assert nself == (0 if name == "pairinrange" else len(pos))


def _fof_cases():
    rng = np.random.default_rng(42)
    n = 4000
    pos = rng.uniform(0, 1, (n, 3))
    for c in rng.uniform(0.2, 0.8, (6, 3)):
        m = rng.integers(0, n, 200)
        pos[m] = c + rng.normal(0, 0.01, (len(m), 3))
    pos = np.mod(pos, 1.0).astype(np.float32)
    yield "random-open", pos, 0.02, None, 1
    yield "random-periodic", pos, 0.02, 1.0, 1
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.normal(0.7, 0.005, (100, 3)),
                          rng.normal(0.3, 0.005, (300, 3)),
                          rng.uniform(0, 1, (50, 3))]).astype(np.float32)
    yield "min-size", pos, 0.05, None, 20
    n = 3000
    t = np.linspace(0, 1, n)
    pos = np.stack([t, 0.5 + 0.02 * np.sin(12 * np.pi * t),
                    0.5 * np.ones(n)], 1)
    pos += np.random.default_rng(1).normal(0, 1e-4, pos.shape)
    yield "filament", pos.astype(np.float32), 3.0 / n, None, 1
    rng = np.random.default_rng(7)
    pos = np.concatenate([np.mod(rng.normal(0.0, 0.01, (200, 3)), 1.0),
                          rng.uniform(0.3, 0.7, (100, 3))])
    yield "wrap", pos.astype(np.float32), 0.05, 1.0, 50
    # equal sizes: eight blobs of 40 members each, numbered by their
    # lowest original index
    rng = np.random.default_rng(5)
    blobs = [c + rng.normal(0, 0.004, (40, 3))
             for c in rng.uniform(0.1, 0.9, (8, 3))]
    pos = np.concatenate(blobs)[rng.permutation(320)]
    yield "equal-sizes", pos.astype(np.float32), 0.03, 1.0, 10


FOF_CASES = {c[0]: c[1:] for c in _fof_cases()}


@pytest.mark.parametrize("case", sorted(FOF_CASES))
def test_fof3d_matches_reference_sweep_and_oracle(case):
    """tests/test_fof.py's cases: ids exactly those of the JAX fof3d, of
    the port's sweep path and (periodic cases) of the float64 oracle."""
    pos, b, box, min_size = FOF_CASES[case]
    want, ng_want = JF.fof3d(jnp.asarray(pos), b, boxsize=box,
                             min_size=min_size)
    got, ng, order = TF.fof3d(torch.from_numpy(pos), b, boxsize=box,
                              min_size=min_size, return_order=True)
    assert got.dtype == torch.int32 and ng == int(ng_want) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(order.tolist()) == list(range(len(pos)))
    tpos = torch.from_numpy(pos)
    sweep, ng_s = SweepFof(tpos, tpos, box, b).fof3d(b, min_size)
    assert ng_s == ng
    np.testing.assert_array_equal(sweep.numpy(), got.numpy())
    if case == "equal-sizes":
        sizes = np.bincount(got.numpy())[1:]
        assert len(sizes) == 8 and (sizes == 40).all()
        firsts = [int(np.nonzero(got.numpy() == g)[0][0])
                  for g in range(1, 9)]
        assert firsts == sorted(firsts)
    if box:
        oracle, ng_o = oracles.fof3d_partition_oracle(pos, b, box, min_size)
        assert ng_o == ng
        np.testing.assert_array_equal(got.numpy(), oracle)


def test_fof_6d_predicate_matches_reference_and_oracle():
    """tests/test_fof.py::test_fof_6d_criterion through both packages, and
    a periodic two-group case against fof6d_partition_oracle."""
    rng = np.random.default_rng(11)
    n = 500
    pos = np.tile(rng.uniform(0.4, 0.6, (n, 3)), (2, 1)).astype(np.float32)
    vel = np.concatenate([rng.normal(+500, 5, (n, 3)),
                          rng.normal(-500, 5, (n, 3))]).astype(np.float32)
    group = np.ones(2 * n, np.int32)
    want, ng_want = JF.fof3d(
        jnp.asarray(pos), 0.05, min_size=10, vel=jnp.asarray(vel),
        extra_fields={"group": jnp.asarray(group)},
        predicate=JF.make_pred_6d(b2=0.05 ** 2, v2=50.0 ** 2))
    got, ng = TF.fof3d(
        torch.from_numpy(pos), 0.05, min_size=10, vel=torch.from_numpy(vel),
        extra_fields={"group": torch.from_numpy(group)},
        predicate=TF.make_pred_6d(b2=0.05 ** 2, v2=50.0 ** 2))
    assert ng == int(ng_want) == 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    pos, vel, rng = _points(8, n=1200)
    pfof3, ng3 = TF.fof3d(torch.from_numpy(pos), 0.3, boxsize=BOX,
                          min_size=20)
    assert ng3 >= 3
    ell6, v2 = 0.2, 60.0 ** 2
    got, ng = TF.fof3d(torch.from_numpy(pos), ell6, boxsize=BOX, min_size=5,
                       vel=torch.from_numpy(vel),
                       extra_fields={"group": pfof3},
                       predicate=TF.Pred6D(ell6 ** 2, v2))
    got = torch.where(pfof3 > 0, got, 0).numpy()
    oracle, ng_o = oracles.fof6d_partition_oracle(
        pos, vel, pfof3.numpy(), ell6, v2, BOX, 5)
    # the oracle links only members of nonzero groups: compare there
    relab = {g: i + 1 for i, g in enumerate(
        sorted(set(got[got > 0]), key=lambda g: (-(got == g).sum(),
                                                 np.nonzero(got == g)[0][0])))}
    got = np.array([relab.get(g, 0) for g in got])
    assert ng_o == len(relab) > 0
    np.testing.assert_array_equal(got, oracle)


def _edge_list(seed, n=200, nedges=8000):
    """Random edges over lattice points at rest in two velocity streams:
    many exactly equal distances."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 4, (n, 3)).astype(np.float32)
    vel = (rng.integers(0, 2, (n, 1)) * np.ones((1, 3))).astype(np.float32)
    erow = rng.integers(0, n, nedges).astype(np.int32)
    ecol = rng.integers(0, n, nedges).astype(np.int32)
    erow[:20] = ecol[:20]                    # self edges never assign
    groups = rng.integers(0, 5, n).astype(np.int32)
    isb = (groups == 0).astype(np.int32)
    return pos, vel, erow, ecol, groups, isb


@pytest.mark.parametrize("periodic", [True, False],
                         ids=["periodic", "open"])
def test_nearest_assign_edges_matches_reference_with_ties(periodic):
    pos, vel, erow, ecol, groups, isb = _edge_list(0)
    box = 4.0 if periodic else None
    grid = jcells.build_grid(np.zeros(3), np.full(3, 4.0), 2.0,
                             periodic=periodic, boxsize=box or 0.0)
    want_g, want_d = JF.nearest_assign_edges(
        jnp.asarray(groups), jnp.asarray(pos),
        {"vel": jnp.asarray(vel), "isb": jnp.asarray(isb)},
        jnp.asarray(erow), jnp.asarray(ecol), grid,
        JB.PhaseMetric(9.0, 4.0))
    got_g, got_d = TF.nearest_assign_edges(
        torch.from_numpy(groups), torch.from_numpy(pos),
        {"vel": torch.from_numpy(vel), "isb": torch.from_numpy(isb)},
        torch.from_numpy(erow).long(), torch.from_numpy(ecol).long(), box,
        TB.PhaseMetric(9.0, 4.0))
    want_g, want_d = np.asarray(want_g), np.asarray(want_d)
    assert got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(np.isinf(got_d.numpy()), np.isinf(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d.numpy()[fin], want_d[fin], rtol=1e-6)
    # ties were planted: some row has two nearest candidates of two groups
    d2 = ((pos[erow] - pos[ecol]) ** 2)
    if periodic:
        d = pos[erow] - pos[ecol]
        d2 = (d - 4.0 * np.round(d / 4.0)) ** 2
    dist = d2.sum(1) / 9.0 + ((vel[erow] - vel[ecol]) ** 2).sum(1) / 4.0
    tie = ((isb[erow] > 0) & (groups[ecol] > 0) & (dist <= 1.0) &
           np.isclose(dist, want_d[erow]))
    ngroups_at_min = np.zeros(len(pos), int)
    for r in np.unique(erow[tie]):
        ngroups_at_min[r] = len(set(groups[ecol[tie & (erow == r)]]))
    assert (ngroups_at_min > 1).sum() >= 5
    assert (want_g > 0).sum() > 20 and (want_g[isb == 0] == 0).all()


@pytest.mark.parametrize("nrounds", [1, 3, 50])
def test_attach_rounds_matches_reference(nrounds):
    _, _, erow, ecol, groups, _ = _edge_list(1, nedges=450)
    want = JF.attach_rounds(jnp.asarray(groups), jnp.asarray(erow),
                            jnp.asarray(ecol), nrounds)
    got = TF.attach_rounds(torch.from_numpy(groups),
                           torch.from_numpy(erow).long(),
                           torch.from_numpy(ecol).long(), nrounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != groups).any()


def test_refine_edge_mask_matches_reference():
    """A 6D criterion along the 3D edges gives the 6D build's pair set,
    and the JAX mask on the same list."""
    pos, vel, rng = _points(5)
    group = rng.integers(1, 3, len(pos)).astype(np.int32)
    fields = {"vel": torch.from_numpy(vel),
              "group": torch.from_numpy(group)}
    e3 = TF.build_edges(torch.from_numpy(pos), 0.3, boxsize=BOX,
                        fields=fields)
    pred = TF.Pred6D(0.2 ** 2, 60.0 ** 2)
    mask = TF.refine_edge_mask(e3.pos_s, e3.fields_s, e3.erow, e3.ecol,
                               e3.boxsize, pred)
    grid = jcells.build_grid(np.zeros(3), np.full(3, BOX), 0.3,
                             periodic=True, boxsize=BOX)
    want = JF.refine_edge_mask(
        jnp.asarray(e3.pos_s.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in e3.fields_s.items()},
        jnp.asarray(e3.erow.numpy().astype(np.int32)),
        jnp.asarray(e3.ecol.numpy().astype(np.int32)), grid,
        JF.Pred6D(0.2 ** 2, 60.0 ** 2))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
    assert 0 < int(mask.sum()) < len(mask)
    e6 = TF.build_edges(torch.from_numpy(pos), 0.2, boxsize=BOX,
                        fields=fields, predicate=pred)
    np.testing.assert_array_equal(
        _pair_set(e3.erow[mask], e3.ecol[mask], e3.order),
        _pair_set(e6.erow, e6.ecol, e6.order))


def test_labels_from_edges_directed_and_undirected_agree():
    """Components of a chain given once per pair or in both orientations:
    one label per component, the component's lowest index; and
    renumber_by_size orders equal sizes by the lowest original index."""
    n = 200
    a = torch.arange(0, n - 1)
    keep = (a % 50) != 49                 # four chains of 50
    erow, ecol = a[keep], a[keep] + 1
    lab_u = TF.fof_labels_from_edges(erow, ecol, n, undirected=True)
    lab_d = TF.fof_labels_from_edges(torch.cat([erow, ecol]),
                                     torch.cat([ecol, erow]), n)
    assert torch.equal(lab_u, lab_d)
    assert torch.equal(lab_u, (torch.arange(n) // 50) * 50)
    want, ng_want = JF.fof_labels_from_edges(
        jnp.asarray(erow.numpy().astype(np.int32)),
        jnp.asarray(ecol.numpy().astype(np.int32)), n, undirected=True), 4
    np.testing.assert_array_equal(lab_u.numpy(), np.asarray(want))
    orig = torch.from_numpy(np.random.default_rng(0).permutation(n))
    got, ng = TF.renumber_by_size(lab_u, 10, orig_index=orig)
    jw, jng = JF.renumber_by_size(jnp.asarray(lab_u.numpy().astype(np.int32)),
                                  10, jnp.asarray(orig.numpy().astype(
                                      np.int32)))
    assert ng == int(jng) == ng_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw))
    got0, ng0 = TF.renumber_by_size(lab_u, 51)
    assert ng0 == 0 and int(got0.abs().sum()) == 0


def test_predicate_constructors():
    assert TF.make_pred_3d(4) == TF.Pred3D(4.0)
    assert TF.make_pred_3d_types(4, 2) == TF.Pred3DTypes(4.0, 2)
    assert TF.make_pred_6d(4, 9, False) == TF.Pred6D(4.0, 9.0, False)
    assert TF.make_pred_6d_scaled(False) == TF.Pred6DScaled(False)
    for pred in (TF.Pred3D(1.0), TF.Pred3DTypes(1.0), TF.Pred6D(1.0, 1.0),
                 TF.Pred6DScaled(), TB._PairInRange(1.0, 1.0)):
        assert pred.symmetric and dataclasses.is_dataclass(pred)
    # FOF3dDM: a link needs both ends dark
    d2 = torch.tensor([0.5, 0.5, 2.0])
    own = {"ptype": torch.tensor([1, 1, 1])}
    nbr = {"ptype": torch.tensor([1, 0, 1])}
    assert TF.Pred3DTypes(1.0)(d2, own, nbr).tolist() == [True, False, False]
    want = JF.Pred3DTypes(1.0)(jnp.asarray(d2.numpy()),
                               {"ptype": jnp.asarray([1, 1, 1])},
                               {"ptype": jnp.asarray([1, 0, 1])})
    assert np.asarray(want).tolist() == [True, False, False]
