"""The port's library API (velociraptor_stf_tpu_torch.api, .particles)
against the JAX package's on the same seeded numpy snapshot.

One JAX ``VelociraptorSession.invoke`` per module (on one device:
``VR_MESH=1``, as the CLI test runs it); the port runs with
``device="cpu"`` from arrays, tensors and a ``ParticleSet``.  Exact: group
ids, group count, hostid, parent and the ``.catalog_groups`` bytes.
Properties within rtol 2e-3, the golden tolerance
(tests/test_torch_properties.py::assert_props_match).
"""

import inspect
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu import api as JA
from velociraptor_stf_tpu import particles as JPS
from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock

from velociraptor_stf_tpu_torch import api as TA
from velociraptor_stf_tpu_torch import particles as TPS

from test_torch_properties import CFG, assert_props_match
from torch_threads import one_torch_thread  # noqa: F401

BOX, N = 25.0, 1 << 14
CFG_TEXT = (Path(__file__).resolve().parents[1] / CFG).read_text() + """
Physical_linking_length=0.2
Halo_3D_linking_length=0.2
FoF_Field_search_type=4
Minimum_size=20
Minimum_halo_size=32
Search_for_substructure=0
Bound_halos=1
Allowed_kinetic_potential_ratio=1.0
Iterate_cm_flag=0
Binary_output=0
"""
SPACING = BOX / N ** (1 / 3)


def _state(api):
    return (api.CosmoInfo(atime=1.0, littleh=0.7, Omega_m=0.3, Omega_b=0.04,
                          Omega_Lambda=0.7),
            api.SimInfo(period=BOX, interparticlespacing=SPACING))


@pytest.fixture(scope="module")
def mock():
    pos, vel, mass = make_cosmo_mock(N, boxsize=BOX, nhalos=6, seed=7)
    return pos, vel, mass, np.arange(1, len(pos) + 1)


@pytest.fixture(scope="module")
def reference(mock, tmp_path_factory):
    """The JAX session's invoke on arrays, with its catalog written."""
    pos, vel, mass, pids = mock
    d = tmp_path_factory.mktemp("api")
    cosmo, sim = _state(JA)
    old = os.environ.get("VR_MESH")
    os.environ["VR_MESH"] = "1"                # one device, no mesh
    try:
        out = JA.VelociraptorSession(config_text=CFG_TEXT).invoke(
            pos, vel, mass, pids=pids, cosmo=cosmo, sim=sim,
            outname=str(d / "jax"), write_output=True)
    finally:
        if old is None:
            os.environ.pop("VR_MESH")
        else:
            os.environ["VR_MESH"] = old
    return d, out


def _invoke(given, mock, **kw):
    """The port's invoke on the CPU, the particles given as ``given``."""
    pos, vel, mass, pids = mock
    cosmo, sim = _state(TA)
    session = TA.VelociraptorSession(config_text=CFG_TEXT)
    if given == "arrays":
        args, ids = (pos, vel, mass), dict(pids=pids)
    elif given == "tensors":
        args = tuple(torch.from_numpy(a) for a in (pos, vel, mass))
        ids = dict(pids=torch.from_numpy(pids))
    elif given == "ParticleSet of tensors":
        args, ids = (TPS.ParticleSet.from_numpy(pos, vel, mass, pid=pids),), {}
    else:
        args, ids = (TPS.ParticleSet(pos, vel, mass, pid=pids),), {}
    return session.invoke(*args, **ids, cosmo=cosmo, sim=sim, device="cpu",
                          **kw)


@pytest.mark.parametrize("given", ["arrays", "tensors",
                                   "ParticleSet of tensors",
                                   "ParticleSet of arrays"])
def test_invoke_matches_reference(reference, mock, given, tmp_path):
    d, want = reference
    got = _invoke(given, mock, outname=str(tmp_path / "torch"),
                  write_output=True)
    # the port's result adds the catalog's stage times
    assert set(got) == set(want) | {"timings"}
    assert got["ngroups"] == want["ngroups"] > 2
    np.testing.assert_array_equal(got["group_id"],
                                  np.asarray(want["group_id"]))
    for key in ("hostid", "parent"):
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert_props_match(got["properties"], want["properties"], got["ngroups"])
    assert (tmp_path / "torch.catalog_groups").read_bytes() == \
        (d / "jax.catalog_groups").read_bytes()
    assert (tmp_path / "torch.properties").stat().st_size > 0
    assert (tmp_path / "torch.catalog_particles").stat().st_size > 0


def test_invoke_returns_the_stage_times(mock):
    """``timings`` holds ``find_structures``' stage seconds."""
    got = _invoke("arrays", mock)
    assert {"to_device", "fof", "properties"} <= set(got["timings"])
    assert all(isinstance(v, float) and v >= 0.0
               for v in got["timings"].values())


def test_invoke_without_ids_or_output_writes_nothing(mock, tmp_path,
                                                     monkeypatch):
    """No ``write_output``: no file; ``write_output`` without ids: the
    property table only, under the default name with the snapshot
    number."""
    pos, vel, mass, _ = mock
    monkeypatch.chdir(tmp_path)
    session = TA.VelociraptorSession(config_text=CFG_TEXT)
    session.opt.outname = str(tmp_path / "cat")
    cosmo, sim = _state(TA)
    out = session.invoke(pos, vel, mass, cosmo=cosmo, sim=sim, device="cpu")
    assert out["ngroups"] > 2 and not list(tmp_path.iterdir())
    session.invoke(pos, vel, mass, snapnum=7, write_output=True,
                   device="cpu")
    assert session.opt.snapshotvalue == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["cat.0007.properties"]


def test_set_simulation_state_sets_the_same_options():
    """Every field the reference's SetVelociraptorSimulationState sets, and
    the derived cosmology, equal the JAX session's."""
    want = JA.VelociraptorSession(config_text=CFG_TEXT)
    got = TA.VelociraptorSession(config_text=CFG_TEXT)
    want.set_simulation_state(*_state(JA))
    got.set_simulation_state(*_state(TA))
    for key in ("a", "h", "Omega_m", "Omega_b", "Omega_cdm", "Omega_Lambda",
                "Omega_r", "w_de", "p", "ellxscale", "icosmologicalin",
                "Omega_k", "rhocrit", "rhobg", "virBN98", "virlevel"):
        assert getattr(got.opt, key) == getattr(want.opt, key), key
    assert got.opt.p == BOX and got.opt.ellxscale == SPACING
    assert got.opt.Omega_cdm == pytest.approx(0.26)
    for key, value in vars(JA.CosmoInfo()).items():
        assert getattr(TA.CosmoInfo(), key) == value, key
    for key, value in vars(JA.SimInfo()).items():
        assert getattr(TA.SimInfo(), key) == value, key


def test_session_constructors(tmp_path):
    """From a config file, text, ``Options`` or nothing, as the reference;
    the default output name; the SWIFT-style wrappers."""
    cfg = tmp_path / "run.cfg"
    cfg.write_text(CFG_TEXT + "Output=named\n")
    by_file = TA.VelociraptorSession(config=str(cfg))
    by_text = TA.VelociraptorSession(config_text=CFG_TEXT)
    assert by_file.opt.outname == "named"
    assert by_text.opt.outname == "vrtpu_output" == \
        JA.VelociraptorSession(config_text=CFG_TEXT).opt.outname
    assert by_file.opt.ellphys == by_text.opt.ellphys == 0.2
    assert TA.VelociraptorSession(opt=by_text.opt).opt is by_text.opt
    assert TA.VelociraptorSession().opt.outname == "vrtpu_output"
    assert TA.init_velociraptor(str(cfg)).opt.outname == "named"
    for fn in (TA.VelociraptorSession.invoke, TA.invoke_velociraptor):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    want = list(inspect.signature(JA.VelociraptorSession.invoke).parameters)
    got = list(inspect.signature(TA.VelociraptorSession.invoke).parameters)
    assert got == want + ["device"]


def test_invoke_velociraptor_wrapper(mock, tmp_path):
    pos, vel, mass, pids = mock
    cosmo, sim = _state(TA)
    session = TA.VelociraptorSession(config_text=CFG_TEXT)
    out = TA.invoke_velociraptor(session, 3, str(tmp_path / "w"), cosmo, sim,
                                 len(pos), pos, vel, mass, pids=pids,
                                 device="cpu")
    assert session.opt.snapshotvalue == 3 and out["ngroups"] > 2
    assert (tmp_path / "w.catalog_groups").exists()
    written = sorted(tmp_path.iterdir())
    again = TA.invoke_velociraptor(session, 4, None, cosmo, sim, len(pos),
                                   pos, vel, mass, device="cpu")
    np.testing.assert_array_equal(again["group_id"], out["group_id"])
    assert sorted(tmp_path.iterdir()) == written   # no name: nothing new


def test_unported_modes_raise(mock):
    """Mixed particle types and substructure, both once refused, now run
    through invoke: the per-type columns, and the substructure catalog
    equal to the JAX API's (ids, hostid, parent, properties)."""
    pos, vel, mass, _ = mock
    cosmo, sim = _state(TA)
    session = TA.VelociraptorSession(config_text=CFG_TEXT)
    ptype = np.where(np.arange(len(pos)) % 6 == 5, 0, 1).astype(np.int8)
    out = session.invoke(pos, vel, mass, ptype=torch.from_numpy(ptype),
                         cosmo=cosmo, sim=sim, device="cpu")
    assert out["ngroups"] > 0
    np.testing.assert_array_equal(
        out["properties"]["n_gas"][1:],
        np.bincount(out["group_id"][ptype == 0],
                    minlength=out["ngroups"] + 1)[1:])
    session.opt.iSubSearch = 1
    got = session.invoke(pos, vel, mass, cosmo=cosmo, sim=sim, device="cpu")
    jsession = JA.VelociraptorSession(config_text=CFG_TEXT)
    jsession.opt.iSubSearch = 1
    old = os.environ.get("VR_MESH")
    os.environ["VR_MESH"] = "1"                # one device, no mesh
    try:
        want = jsession.invoke(pos, vel, mass, cosmo=_state(JA)[0],
                               sim=_state(JA)[1])
    finally:
        if old is None:
            os.environ.pop("VR_MESH")
        else:
            os.environ["VR_MESH"] = old
    assert got["ngroups"] == want["ngroups"]
    np.testing.assert_array_equal(got["group_id"], want["group_id"])
    for key in ("hostid", "parent"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert_props_match(got["properties"], want["properties"],
                       got["ngroups"])


@pytest.mark.parametrize("kind", ["tensors", "arrays"])
def test_particle_set_matches_reference(kind):
    """n, masses (scalar or per particle), replace, take and the default
    ids and types, against the JAX ParticleSet on the same arrays."""
    rng = np.random.default_rng(4)
    n = 50
    pos = rng.random((n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.random(n).astype(np.float32)
    idx = rng.permutation(n)[:20]
    wrap = torch.as_tensor if kind == "tensors" else (lambda a: a)

    def host(a):
        return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    want = JPS.ParticleSet.from_numpy(pos, vel, mass)
    got = TPS.ParticleSet(wrap(pos), wrap(vel), wrap(mass))
    assert got.n == want.n == n and "n=50" in repr(got)
    assert isinstance(got.pid, torch.Tensor) == (kind == "tensors")
    for field in ("pid", "ptype", "mass"):
        np.testing.assert_array_equal(host(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
        assert host(getattr(got, field)).dtype == \
            np.asarray(getattr(want, field)).dtype
    assert got.ptype[0] == TPS.DARK == JPS.DARK
    assert all(getattr(got, f) is None for f in
               ("density", "potential", "u", "sfr", "zmet", "tage"))
    t_got, t_want = got.take(wrap(idx)), want.take(idx)
    for field in ("pos", "vel", "mass", "pid", "ptype"):
        np.testing.assert_array_equal(host(getattr(t_got, field)),
                                      np.asarray(getattr(t_want, field)))
    assert t_got.n == 20 and t_got.u is None
    # a scalar mass broadcasts, and take keeps it a scalar
    s_got = got.replace(mass=wrap(np.float32(2.5)), u=wrap(mass))
    s_want = want.replace(mass=np.float32(2.5))
    np.testing.assert_array_equal(host(s_got.masses()),
                                  np.asarray(s_want.masses()))
    assert host(s_got.masses()).shape == (n,)
    assert np.ndim(host(s_got.take(wrap(idx)).mass)) == 0
    np.testing.assert_array_equal(host(s_got.take(wrap(idx)).u), mass[idx])
    assert s_got.pos is got.pos and got.u is None
    for name in ("GAS", "DARK", "DARK2", "DARK3", "STAR", "BH", "WIND",
                 "TRACER"):
        assert getattr(TPS, name) == getattr(JPS, name)


def test_particle_set_from_numpy_keeps_long_ids():
    """Ids above 2^31 - 1 become an int64 tensor (the reference keeps them
    in host numpy); smaller ids int32, as the reference's."""
    pos = np.zeros((4, 3))
    big = np.array([1, 2**31, 2**40, 7])
    ps = TPS.ParticleSet.from_numpy(pos, pos, 1.0, pid=big,
                                    ptype=[1, 0, 4, 1])
    assert ps.pid.dtype == torch.int64 and ps.pid.tolist() == big.tolist()
    assert JPS.ParticleSet.from_numpy(pos, pos, 1.0, pid=big).pid.dtype == \
        np.int64
    assert ps.pos.dtype == torch.float32 and ps.ptype.dtype == torch.int8
    assert ps.masses().shape == (4,) and float(ps.masses()[3]) == 1.0
    small = TPS.ParticleSet.from_numpy(pos, pos, np.ones(4), pid=big % 1000)
    assert small.pid.dtype == torch.int32
    assert ps.take([2, 0]).pid.tolist() == [2**40, 1]
