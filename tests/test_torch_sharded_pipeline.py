"""The port's find_structures(mesh=) (velociraptor_stf_tpu_torch/parallel/)
on meshes of CPU shards against the port's single-device run and the JAX
package's (the port's counterpart of tests/test_sharded_pipeline.py): the
main path (also against the JAX package's own mesh run), iKeepFOF, the
baryon mode, every property key, the substructure recursion on planted
subhalos and the recursion with the sharded density
(tests/test_torch_collective_audit.py drives the CLI with ``VR_MESH=8
--device cpu``).

Gates: group ids, bound masks, pfof3d, hierarchy and association exactly
equal to the port's single-device run; potentials equal bit for bit
(the shards lay each group out at its single-device offset modulo the
potential's tile); gmass / gM200c / gR200c / gMvir within rtol 1e-6 (the
JAX package's gate: the SO histograms add the shards' partial sums);
every other property within rtol 5e-5 (the JAX package's all-keys gate).
Against the JAX package: ids exact, properties within the port's golden
tolerance (tests/test_torch_properties.py::assert_props_match).  With the
sharded density, the JAX package's statistical gate.
"""

from collections import defaultdict

import numpy as np
import pytest

from velociraptor_stf_tpu.models import pipeline as JP
from velociraptor_stf_tpu.parallel.mesh import make_mesh as jax_mesh
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS, make_cosmo_mock,
                                                     planted_subhalos)
from velociraptor_stf_tpu_torch.models import pipeline as TP
from velociraptor_stf_tpu_torch.parallel import distributed_localfield
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh

from test_torch_properties import assert_props_match
from torch_threads import one_torch_thread  # noqa: F401

SO_KEYS = ("gmass", "gM200c", "gR200c", "gMvir")


def _canon(pfof):
    d = defaultdict(list)
    for i, g in enumerate(np.asarray(pfof)):
        if g > 0:
            d[g].append(i)
    return set(frozenset(v) for v in d.values())


def _opt(n, boxsize, **over):
    """tests/test_sharded_pipeline.py's options."""
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF6D
    opt.MinSize = 20
    opt.HaloMinSize = 32
    opt.uinfo.unbindflag = 1
    opt.iBoundHalos = 1
    opt.uinfo.Eratio = 1.0
    opt.G = 43.0211349
    opt.iSubSearch = 0
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


def _port(opt, *args, mesh=None, **kw):
    return TP.find_structures(convert.options(opt), *args, device="cpu",
                              mesh=mesh, **kw)


def assert_same(got, want, so_rtol=1e-6):
    """The mesh run against the single-device port run."""
    assert got.ngroups == want.ngroups > 0
    np.testing.assert_array_equal(got.pfof, want.pfof)
    for k in ("pfof3d", "W", "hostid", "parent", "hierarchy_level",
              "stype"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert set(got.props) == set(want.props)
    for k in want.props:
        a = np.asarray(want.props[k], np.float64)[1:]
        b = np.asarray(got.props[k], np.float64)[1:]
        assert a.shape == b.shape, k
        rtol = so_rtol if k in SO_KEYS else 5e-5
        scale = np.maximum(np.abs(a), np.abs(b)).max(initial=0.0)
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=0 if k in SO_KEYS else
                                   rtol * max(scale, 1e-30), err_msg=k)


MAIN_N, MAIN_BOX = 1 << 15, 50.0


@pytest.fixture(scope="module")
def main_case():
    """tests/test_sharded_pipeline.py:52-71: FOF6D, field unbind,
    properties and the all-particle SO, one device and a mesh of 8."""
    pos, vel, mass = make_cosmo_mock(MAIN_N, boxsize=MAIN_BOX, nhalos=24,
                                     seed=11)
    opt = _opt(MAIN_N, MAIN_BOX, iInclusiveHalo=3)
    one = _port(opt, pos, vel, mass, boxsize=MAIN_BOX)
    eight = _port(opt, pos, vel, mass, boxsize=MAIN_BOX,
                  mesh=make_mesh(8, "cpu"))
    return opt, pos, vel, mass, one, eight


def test_main_path_mesh_matches_single_device(main_case):
    opt, pos, vel, mass, one, eight = main_case
    assert_same(eight, one)
    assert {"fof", "unbind", "properties", "so"} <= set(eight.timings)


@pytest.fixture(scope="module")
def reference_mesh(main_case):
    """The JAX package's own mesh run on its 8 virtual devices."""
    opt, pos, vel, mass, _, _ = main_case
    return JP.find_structures(opt, pos, vel, mass, boxsize=MAIN_BOX,
                              mesh=jax_mesh(8))


def test_main_path_mesh_matches_reference_mesh(main_case, reference_mesh):
    """The partition, pfof3d and group count of the JAX package's mesh
    run (which tests/test_sharded_pipeline.py holds to its one-device
    run)."""
    eight, want = main_case[5], reference_mesh
    assert eight.ngroups == want.ngroups
    assert _canon(eight.pfof) == _canon(want.pfof)
    assert _canon(eight.pfof3d) == _canon(want.pfof3d)


def test_main_path_mesh_properties_match_reference_mesh(main_case,
                                                        reference_mesh):
    eight, want = main_case[5], reference_mesh
    np.testing.assert_array_equal(eight.pfof, np.asarray(want.pfof))
    assert_props_match(eight.props, want.props, eight.ngroups)


@pytest.mark.parametrize("ndev", [2, 3])
def test_main_path_other_mesh_sizes(main_case, ndev):
    opt, pos, vel, mass, one, _ = main_case
    got = _port(opt, pos, vel, mass, boxsize=MAIN_BOX,
                mesh=make_mesh(ndev, "cpu"))
    assert_same(got, one)


def test_keepfof_mesh_matches_single_device():
    boxsize, n = 40.0, 1 << 14
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=10, seed=19)
    opt = _opt(n, boxsize, iKeepFOF=1, fofbgtype=C.FOF6DADAPTIVE)
    one = _port(opt, pos, vel, mass, boxsize=boxsize)
    got = _port(opt, pos, vel, mass, boxsize=boxsize,
                mesh=make_mesh(8, "cpu"))
    assert (one.stype == C.FOF3DTYPE).sum() > 0
    assert_same(got, one)


def test_baryon_mode_mesh_matches_single_device():
    """Baryon association (slab plan, ghost DM) and the combined unbind
    over the mesh: the same association and catalog."""
    boxsize, n = 40.0, 1 << 14
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=10, seed=5)
    ptype = np.where(np.arange(n) % 6 == 5, C.GASTYPE,
                     C.DARKTYPE).astype(np.int32)
    opt = _opt(n, boxsize, iBaryonSearch=1, partsearchtype=C.PSTALL)
    one = _port(opt, pos, vel, mass, boxsize=boxsize, ptype=ptype)
    got = _port(opt, pos, vel, mass, boxsize=boxsize, ptype=ptype,
                mesh=make_mesh(8, "cpu"))
    gas = ptype == C.GASTYPE
    assert (one.pfof[gas] > 0).any()
    assert_same(got, one)


def test_property_stage_mesh_all_keys():
    """Every key of the property bundle with apertures and the RVmax
    block (tests/test_sharded_pipeline.py:224)."""
    boxsize, n = 50.0, 1 << 15
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=24, seed=13)
    opt = _opt(n, boxsize, iaperturecalc=1, aperture_values_kpc=[30.0, 100.0],
               aperturenum=2, lengthtokpc=1000.0, iextrahalooutput=1)
    one = _port(opt, pos, vel, mass, boxsize=boxsize)
    got = _port(opt, pos, vel, mass, boxsize=boxsize,
                mesh=make_mesh(8, "cpu"))
    assert {"Aperture_mass_1", "RVmax_npart"} <= set(one.props)
    assert_same(got, one)


PLANT_BOX = 16.0


def _planted_opts(**over):
    """tests/test_torch_subcatalog.py::planted_options."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.iSubSearch, opt.iiterflag = 1, 1
    opt.ellthreshold, opt.Vratio, opt.thetaopen, opt.ellfac = \
        2.5, 2.0, 0.10, 1.0
    opt.uinfo.unbindflag, opt.uinfo.Eratio, opt.iBoundHalos = 1, 1.0, 1
    opt.G = G_KMS
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


@pytest.mark.parametrize("bound", [1, 2])
def test_recursion_mesh_planted_subhalos(bound):
    """Structures dealt whole to the shards: ids, parents and levels
    equal to one device's (which tests/test_torch_subcatalog.py holds to
    the JAX package's)."""
    pos, vel, mass, host = planted_subhalos(3, seed=3, offset=4.0)
    opt = _planted_opts(iBoundHalos=bound)
    one = _port(opt, pos, vel, mass, boxsize=PLANT_BOX)
    got = _port(opt, pos, vel, mass, boxsize=PLANT_BOX,
                mesh=make_mesh(8, "cpu"))
    assert (one.parent > 0).sum() >= 2
    assert_same(got, one)
    # every substructure inside its host's planted halo
    for g in np.nonzero(got.parent > 0)[0]:
        assert len(np.unique(host[got.pfof == g])) == 1


def test_recursion_mesh_sharded_density(monkeypatch):
    """The density sharded as x-slabs (threshold lowered): the field
    halos exactly, the whole catalog at the JAX package's gate (label
    match above 0.98; tests/test_sharded_pipeline.py:256)."""
    from velociraptor_stf_tpu.io.synthetic import labels_match_rate

    monkeypatch.setattr(distributed_localfield, "DIST_DENSITY_MIN", 1)
    calls = []
    real = distributed_localfield.distributed_velocity_density
    monkeypatch.setattr(distributed_localfield,
                        "distributed_velocity_density",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    boxsize, n = 40.0, 1 << 15
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=12, seed=9)
    opt = _opt(n, boxsize, iSubSearch=1, iiterflag=1)
    one = _port(opt, pos, vel, mass, boxsize=boxsize)
    got = _port(opt, pos, vel, mass, boxsize=boxsize,
                mesh=make_mesh(8, "cpu"))
    assert calls
    host1, host8 = one.pfof.copy(), got.pfof.copy()
    if one.parent is not None:
        host1[one.parent[host1] > 0] = 0
    if got.parent is not None:
        host8[got.parent[host8] > 0] = 0
    assert labels_match_rate(host1, host8, min_size=20) == 1.0
    assert labels_match_rate(one.pfof, got.pfof, min_size=20) > 0.98
