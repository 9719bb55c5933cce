"""Faults of the port repaired against the JAX package's behaviour
(ROADMAP queue 3), port against port, no JAX run: the entry points leave
their callers' tensors as they were (F4), a half-mass radius at a tie of
the cumulative mass (F5), and the mesh's catalog equals one device's on
memberless groups (F6).

F4: ``search_sub_sub`` once took ``pfof.to(dev).long()``, which is the
caller's own tensor when that is already int64 on the device, and its
splice wrote the substructure ids into it: with ``Bound_halos=0`` that
tensor was also the pipeline's pre-unbind ids for the inclusive masses.
The inputs here are handed over as tensors that already lie on the
device with their final dtype, where a ``.to()`` returns them as they
are.  F5: a group whose cumulative mass reaches half its total exactly.
F6: the mesh's property stage once left the rows of groups the unbind
emptied at zero (one device gives them gsize -inf, cNFW -1, ...), and
its sigmas depended on the shard's group count (a batched LU and the
CPU's vectorised pow).
"""

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu_torch import api
from velociraptor_stf_tpu_torch.io.synthetic import G_KMS, planted_subhalos
from velociraptor_stf_tpu_torch.models import pipeline as TP
from velociraptor_stf_tpu_torch.models import properties as props_mod
from velociraptor_stf_tpu_torch.models import substructure as S
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.utils import config as C

from test_torch_subcatalog import half_mass_ties
from torch_threads import one_torch_thread  # noqa: F401

BOX = 16.0


def planted_options(**over):
    """tests/test_torch_subcatalog.py::planted_options in the port's
    Options, with the inclusive masses of the field search's ids."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.iSubSearch, opt.iiterflag = 1, 1
    opt.ellthreshold, opt.Vratio, opt.thetaopen, opt.ellfac = \
        2.5, 2.0, 0.10, 1.0
    opt.uinfo.unbindflag, opt.uinfo.Eratio = 1, 1.0
    opt.iBoundHalos, opt.iInclusiveHalo = 0, 2
    opt.G = G_KMS
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


@pytest.fixture(scope="module")
def planted():
    """Three planted hosts with subhalos as tensors, a sixth of them gas
    (0.6 of the DM mass), with hydro fields."""
    pos, vel, mass, _ = planted_subhalos(3, seed=3, offset=4.0)
    n = len(pos)
    ptype = np.where(np.arange(n) % 6 == 5, 0, 1)
    mass = np.where(ptype == 0, 0.6 * mass, mass).astype(np.float32)
    rng = np.random.default_rng(4)
    t = {"pos": torch.from_numpy(pos), "vel": torch.from_numpy(vel),
         "mass": torch.from_numpy(mass),
         "ptype": torch.from_numpy(ptype.astype(np.int64)),
         "u": torch.from_numpy(rng.uniform(1, 2, n).astype(np.float32)),
         "sfr": torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))}
    return t


def _unchanged(tensors, before):
    for k, v in tensors.items():
        assert torch.equal(v, before[k]), f"{k} was written into"


@pytest.mark.parametrize("shards", [0, 4])
def test_search_sub_sub_leaves_pfof_unchanged(planted, shards):
    """On one device and on a mesh of four CPU shards: the argument is
    int64 on its device, so only a copy keeps the splice off it."""
    opt = planted_options()
    mesh = make_mesh(shards, "cpu") if shards else None
    p = planted
    sres = TP.search_and_unbind(opt, p["pos"], p["vel"], p["mass"],
                                boxsize=BOX, device="cpu")
    pfof, ng = sres.pfof_fof.clone(), sres.ngroups_fof
    assert pfof.dtype == torch.int64 and pfof.device.type == "cpu"
    before = pfof.clone()
    out, ng_total, hostid, parent, _ = S.search_sub_sub(
        opt, p["pos"], p["vel"], p["mass"], pfof, ng, boxsize=BOX,
        mesh=mesh)
    assert ng_total > ng and int(out.max()) > ng
    assert torch.equal(pfof, before)
    assert out.data_ptr() != pfof.data_ptr()


@pytest.mark.parametrize("baryons", [0, 1])
def test_find_structures_leaves_inputs_unchanged(planted, baryons):
    """Bound_halos 0 with the inclusive masses, with and without the
    baryon search (which splices the DM and baryon ids)."""
    opt = planted_options(iBaryonSearch=baryons, partsearchtype=C.PSTALL)
    before = {k: v.clone() for k, v in planted.items()}
    p = planted
    res = TP.find_structures(opt, p["pos"], p["vel"], p["mass"],
                             boxsize=BOX, ptype=p["ptype"],
                             extras={"u": p["u"], "sfr": p["sfr"]},
                             device="cpu")
    assert (res.parent[1:] > 0).sum() >= 1
    assert np.isfinite(res.props["gM200c"][1:]).all()
    _unchanged(planted, before)


def test_invoke_leaves_inputs_unchanged(planted):
    before = {k: v.clone() for k, v in planted.items()}
    p = planted
    s = api.VelociraptorSession(opt=planted_options(iBaryonSearch=1,
                                                    partsearchtype=C.PSTALL))
    pids = torch.arange(1, p["pos"].shape[0] + 1)
    out = s.invoke(p["pos"], p["vel"], p["mass"], pids=pids,
                   ptype=p["ptype"], extras={"u": p["u"], "sfr": p["sfr"]},
                   sim=api.SimInfo(period=BOX, interparticlespacing=0.25),
                   device="cpu")
    assert out["ngroups"] > 0 and (out["parent"][1:] > 0).any()
    _unchanged(planted, before)
    assert torch.equal(pids, torch.arange(1, p["pos"].shape[0] + 1))


def test_inclusive_masses_mesh_equals_one_device(planted):
    """Inclusive_halo_masses=2 and Bound_halos=0 with a substructure
    found: the catalog over four CPU shards equals one device's."""
    opt = planted_options()
    p = planted
    one = TP.find_structures(opt, p["pos"], p["vel"], p["mass"],
                             boxsize=BOX, device="cpu")
    got = TP.find_structures(opt, p["pos"], p["vel"], p["mass"],
                             boxsize=BOX, mesh=make_mesh(4, "cpu"))
    assert (one.parent[1:] > 0).sum() >= 1
    assert got.ngroups == one.ngroups
    for k in ("pfof", "hostid", "parent", "hierarchy_level"):
        np.testing.assert_array_equal(getattr(got, k), getattr(one, k), k)
    assert set(got.props) == set(one.props)
    for k in one.props:
        np.testing.assert_array_equal(got.props[k], one.props[k], k)


def test_half_mass_radius_at_a_tie():
    """F5: group 1's members, by distance from its potential minimum,
    weigh 6.0, 0.15, 6.0 and 0.15, so the cumulative mass after two of
    them is exactly half the total 12.3 (in float64 from the float32
    masses).  The port's half-mass radius is the float64 oracle's (the
    first radius where the cumulative mass exceeds half), and the tie
    helper flags group 1 and no other: group 2 (1, 2, 4) and group 3
    (three of 1.0) never reach half exactly."""
    offs = np.array([[2.0, 2.0, 2.0], [5.0, 5.0, 5.0], [8.0, 2.0, 5.0]])
    radii = np.array([0.0, 0.1, 0.2, 0.3], np.float32)
    pos, mass, pfof, W = [], [], [], []
    for g, ms in enumerate(([6.0, 0.15, 6.0, 0.15], [1.0, 2.0, 4.0],
                            [1.0, 1.0, 1.0]), start=1):
        k = len(ms)
        d = np.zeros((k, 3), np.float32)
        d[:, g % 3] = radii[:k]
        pos.append(offs[g - 1] + d)
        mass += ms
        pfof += [g] * k
        W += [-10.0] + [-1.0] * (k - 1)        # potential minimum: row 0
    pos = np.concatenate(pos).astype(np.float32)
    mass = np.array(mass, np.float32)
    pfof, W = np.array(pfof), np.array(W, np.float32)
    opt = C.Options()
    opt.iPropertyReferencePosition = C.PROPREFMINPOT
    t = [torch.from_numpy(a) for a in (pos, np.zeros_like(pos), mass, pfof,
                                       W)]
    pr = props_mod.property_bundle(opt, t[0], t[1], t[2], t[3], 3, W=t[4])
    pr = {k: v.numpy() for k, v in pr.items()}
    # float64 oracle: the first radius whose cumulative mass exceeds half
    m64 = mass[:4].astype(np.float64)
    c = np.cumsum(m64)
    assert c[1] == 0.5 * c[-1]
    want = float(radii[np.nonzero(c > 0.5 * c[-1])[0][0]])
    assert want == np.float32(0.2)
    np.testing.assert_allclose(pr["gRhalfmass"][1], want, rtol=1e-6)
    ties = half_mass_ties(opt, pr, pos, mass, pfof, W=W)
    tied, acc = ties["gRhalfmass"]
    assert tied.tolist() == [False, True, False, False]
    np.testing.assert_allclose(acc[1], [0.2, 0.1, 0.2], rtol=1e-6)
    assert ties["gMassTwiceRhalfmass"][0].tolist() == tied.tolist()



def test_mesh_properties_with_memberless_groups(planted):
    """F6: a group the unbind emptied (here group 2, and one more id past
    the last group) gets the same row from the property stage over four
    CPU shards as on one device, and every other row too, bit for bit."""
    from velociraptor_stf_tpu_torch.parallel.distributed_props import \
        distributed_properties

    opt = planted_options()
    p = planted
    sres = TP.search_and_unbind(opt, p["pos"], p["vel"], p["mass"],
                                boxsize=BOX, device="cpu")
    pfof = torch.where(sres.pfof == 2, 0, sres.pfof)
    ng = sres.ngroups + 1
    sub = TP._tagged_by_group(pfof)
    one = props_mod.property_bundle(
        opt, p["pos"][sub], p["vel"][sub], p["mass"][sub], pfof[sub], ng,
        boxsize=BOX)
    got = distributed_properties(opt, p["pos"], p["vel"], p["mass"], pfof,
                                 ng, make_mesh(4, "cpu"), boxsize=BOX)
    assert set(got) == set(one)
    assert np.isinf(one["gsize"][[2, ng]].numpy()).all()
    for k, v in one.items():
        np.testing.assert_array_equal(got[k][1:], v.numpy()[1:], k)
