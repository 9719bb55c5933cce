"""The port's baryon association (velociraptor_stf_tpu_torch/models/
baryons.py) and the hydro path of its find_structures and CLI against the
JAX package's on the same numpy inputs.

Exact: baryon group ids, pfof, ngroups, hierarchy, bound masks (pfof > 0),
the CLI's .catalog_groups bytes.  W within rel 1e-4.  Properties within
rtol 2e-3, atol 2e-3 * max|want| (tests/test_torch_properties.py::
assert_props_match, eigenvectors up to sign).
"""

import dataclasses
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu import cli as jcli
from velociraptor_stf_tpu.io import gadget
from velociraptor_stf_tpu.models import baryons as JB
from velociraptor_stf_tpu.models import pipeline as JP
from velociraptor_stf_tpu.ops import fof as JF
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import baryons as TB
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.models import pipeline as TP
from velociraptor_stf_tpu_torch.ops import fof as TF
from velociraptor_stf_tpu_torch.utils import telemetry

from test_torch_properties import CFG, assert_props_match
from torch_threads import one_torch_thread  # noqa: F401

G = 43.0211349


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(opt, pos_dm, vel_dm, pfof_dm, pos_b, vel_b, boxsize=None,
          vscale2=None):
    """(JAX ids, port ids) of one search_baryons input."""
    want = np.asarray(JB.search_baryons(opt, pos_dm, vel_dm, pfof_dm, pos_b,
                                        vel_b, boxsize=boxsize,
                                        vscale2=vscale2))
    got = TB.search_baryons(convert.options(opt), _t(pos_dm), _t(vel_dm),
                            _t(pfof_dm).long(), _t(pos_b), _t(vel_b),
                            boxsize=boxsize, vscale2=vscale2)
    assert got.dtype == torch.int32 and got.shape == (len(pos_b),)
    return want, got.numpy()


def _two_halos(rng):
    """tests/test_baryons.py:12: two DM halos, baryons in each and far
    from both."""
    n1, n2, nb = 2000, 1500, 600
    c1, c2 = np.array([2.0, 2, 2]), np.array([8.0, 8, 8])
    pos_dm = np.concatenate([c1 + rng.normal(0, 0.1, (n1, 3)),
                             c2 + rng.normal(0, 0.1, (n2, 3))])
    vel_dm = np.concatenate([rng.normal(0, 50, (n1, 3)),
                             np.array([300.0, 0, 0]) +
                             rng.normal(0, 50, (n2, 3))])
    pfof_dm = np.concatenate([np.ones(n1, np.int32),
                              np.full(n2, 2, np.int32)])
    pos_b = np.concatenate([c1 + rng.normal(0, 0.1, (nb // 3, 3)),
                            c2 + rng.normal(0, 0.1, (nb // 3, 3)),
                            rng.uniform(4, 6, (nb // 3, 3))])
    vel_b = np.concatenate([rng.normal(0, 50, (nb // 3, 3)),
                            np.array([300.0, 0, 0]) +
                            rng.normal(0, 50, (nb // 3, 3)),
                            rng.normal(0, 50, (nb // 3, 3))])
    return tuple(a.astype(np.float32) for a in (pos_dm, vel_dm)) + \
        (pfof_dm,) + tuple(a.astype(np.float32) for a in (pos_b, vel_b))


def test_baryons_assigned_to_nearest_halo():
    args = _two_halos(np.random.default_rng(0))
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 1.0
    want, got = _both(opt, *args)
    np.testing.assert_array_equal(got, want)
    third = len(got) // 3
    assert (got[:third] == 1).mean() > 0.85
    assert (got[third:2 * third] == 2).mean() > 0.85
    assert (got[2 * third:] == 0).all()


def test_baryon_kinematic_discrimination():
    """tests/test_baryons.py:48: a baryon between two overlapping halos
    goes with the one that matches its velocity."""
    rng = np.random.default_rng(1)
    n = 1000
    c = np.array([5.0, 5, 5])
    pos_dm = np.concatenate([c + rng.normal(0, 0.05, (n, 3)),
                             c + rng.normal(0, 0.05, (n, 3))]
                            ).astype(np.float32)
    vel_dm = np.concatenate([rng.normal(0, 20, (n, 3)),
                             np.array([400.0, 0, 0]) +
                             rng.normal(0, 20, (n, 3))]).astype(np.float32)
    pfof_dm = np.concatenate([np.ones(n, np.int32), np.full(n, 2, np.int32)])
    pos_b = (c + rng.normal(0, 0.05, (100, 3))).astype(np.float32)
    vel_b = (np.array([400.0, 0, 0]) +
             rng.normal(0, 20, (100, 3))).astype(np.float32)
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.25
    want, got = _both(opt, pos_dm, vel_dm, pfof_dm, pos_b, vel_b)
    np.testing.assert_array_equal(got, want)
    assert (got == 2).mean() > 0.9


def _uniform_case(seed=13, boxsize=10.0, nd=3000, nb=800):
    rng = np.random.default_rng(seed)
    pos_dm = rng.uniform(0, boxsize, (nd, 3)).astype(np.float32)
    vel_dm = rng.normal(0, 50, (nd, 3)).astype(np.float32)
    pfof_dm = rng.integers(0, 4, nd).astype(np.int32)
    pos_b = rng.uniform(0, boxsize, (nb, 3)).astype(np.float32)
    vel_b = rng.normal(0, 50, (nb, 3)).astype(np.float32)
    return pos_dm, vel_dm, pfof_dm, pos_b, vel_b


def test_symmetric_edge_build_matches_directed_and_streamed():
    """tests/test_baryons.py:226 in the port: the each-pair-once edge
    build with the metric on both orientations, the directed build and
    the streamed pass of search_baryons give one assignment, the JAX
    package's."""
    boxsize = 10.0
    pos_dm, vel_dm, pfof_dm, pos_b, vel_b = _uniform_case()
    nd, nb = len(pos_dm), len(pos_b)
    ellx, ellv2 = 0.4, 2500.0

    jmetric = JB.PhaseMetric(float(ellx * ellx), ellv2)
    jpos = jnp.concatenate([jnp.asarray(pos_dm), jnp.asarray(pos_b)])
    jvel = jnp.concatenate([jnp.asarray(vel_dm), jnp.asarray(vel_b)])
    jisb = jnp.concatenate([jnp.zeros(nd, jnp.int32),
                            jnp.ones(nb, jnp.int32)])
    jgroups = jnp.concatenate([jnp.asarray(pfof_dm),
                               jnp.zeros(nb, jnp.int32)])
    je, _, jgrid = JF.build_edges(
        jpos, ellx, boxsize=boxsize, fields={"vel": jvel, "isb": jisb},
        predicate=JB._PairInRange(float(ellx * ellx), ellv2))
    erow = jnp.concatenate([je.erow, je.ecol])
    ecol = jnp.concatenate([je.ecol, je.erow])
    jg, _ = JF.nearest_assign_edges(jgroups[je.order], je.pos_s, je.fields_s,
                                    erow, ecol, jgrid, jmetric)
    want = np.zeros(nd + nb, np.int32)
    want[np.asarray(je.order)] = np.asarray(
        jnp.where(je.fields_s["isb"] > 0, jg, jgroups[je.order]))

    metric = TB.PhaseMetric(float(ellx * ellx), ellv2)

    @dataclasses.dataclass(frozen=True)
    class DirectedElig:
        metric: object

        def __call__(self, d2, own, nbr):
            return self.metric(d2, own, nbr)[1]

    pos = torch.cat([_t(pos_dm), _t(pos_b)])
    fields = {"vel": torch.cat([_t(vel_dm), _t(vel_b)]),
              "isb": torch.cat([torch.zeros(nd, dtype=torch.int32),
                                torch.ones(nb, dtype=torch.int32)])}
    groups = torch.cat([_t(pfof_dm), torch.zeros(nb, dtype=torch.int32)])
    for pred, half in ((TB._PairInRange(float(ellx * ellx), ellv2), None),
                       (DirectedElig(metric), False)):
        e = TF.build_edges(pos, ellx, boxsize=boxsize, fields=fields,
                           predicate=pred, half=half)
        assert e.undirected == (half is None)
        erow, ecol = e.erow, e.ecol
        if e.undirected:
            erow, ecol = torch.cat([erow, ecol]), torch.cat([ecol, erow])
        gs = groups[e.order]
        grp_s, _ = TF.nearest_assign_edges(gs, e.pos_s, e.fields_s, erow,
                                           ecol, e.boxsize, metric)
        out = np.zeros(nd + nb, np.int32)
        out[e.order.numpy()] = torch.where(e.fields_s["isb"] > 0, grp_s,
                                           gs).numpy()
        np.testing.assert_array_equal(out, want)
    assert (want[nd:] > 0).any()
    streamed, _, pairs = TF.nearest_assign_points(
        _t(pos_b), {"vel": _t(vel_b), "isb": torch.tensor(1)},
        _t(pos_dm)[pfof_dm > 0],
        {"vel": _t(vel_dm)[pfof_dm > 0], "isb": torch.tensor(0)},
        _t(pfof_dm)[pfof_dm > 0], ellx, boxsize, metric)
    np.testing.assert_array_equal(streamed.numpy(), want[nd:])
    assert pairs > nb


@pytest.mark.parametrize("boxsize", [10.0, None], ids=["periodic", "open"])
def test_search_baryons_uniform_matches_reference(boxsize):
    """Random tagged and untagged DM: ids equal with the velocity scale
    each package measures itself, and with the JAX value handed over."""
    args = _uniform_case(seed=5)
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.4, 1.0
    telemetry.reset()
    want, got = _both(opt, *args, boxsize=boxsize)
    np.testing.assert_array_equal(got, want)
    assert 10 < (want > 0).sum() < len(want)
    assert telemetry.snapshot()["baryon_pairs"] > len(want)
    # the scale alone: the port's float32 sums against the JAX package's
    vel_dm, pfof_dm = args[1], args[2]
    sel = pfof_dm > 0
    w = jnp.asarray(sel.astype(np.float32))
    mt = jnp.maximum(jnp.sum(w), 1.0)
    vm = jnp.sum(jnp.asarray(vel_dm) * w[:, None], 0) / mt
    jv = float(jnp.sum(jnp.sum((jnp.asarray(vel_dm) - vm) ** 2, -1) * w)
               / mt)
    tv = TB.velocity_scale2(_t(vel_dm), _t(pfof_dm))
    assert abs(tv - jv) <= 1e-5 * jv
    want2, got2 = _both(opt, *args, boxsize=boxsize, vscale2=jv)
    np.testing.assert_array_equal(want2, want)
    np.testing.assert_array_equal(got2, want)
    # Halo_velocity_dispersion_scale replaces the measurement
    opt.HaloVelDispScale = 900.0
    want3, got3 = _both(opt, *args, boxsize=boxsize)
    np.testing.assert_array_equal(got3, want3)
    assert (want3 != want).any()


def test_search_baryons_without_tagged_dm_and_mesh():
    pos_dm, vel_dm, pfof_dm, pos_b, vel_b = _uniform_case(nd=200, nb=50)
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.4, 1.0
    want, got = _both(opt, pos_dm, vel_dm, np.zeros_like(pfof_dm), pos_b,
                      vel_b, boxsize=10.0)
    assert not want.any() and not got.any()
    none = TB.search_baryons(convert.options(opt), _t(pos_dm), _t(vel_dm),
                             _t(pfof_dm).long(), _t(pos_b[:0]), _t(vel_b[:0]))
    assert none.shape == (0,)
    # over a mesh of CPU shards: the assignment of one device
    opt.ellphys = 1.0
    args = (convert.options(opt), _t(pos_dm), _t(vel_dm),
            _t(pfof_dm).long(), _t(pos_b), _t(vel_b))
    one = TB.search_baryons(*args, boxsize=10.0, vscale2=1e6)
    assert one.any()
    assert torch.equal(TB.search_baryons(*args, boxsize=10.0, vscale2=1e6,
                                         mesh=make_mesh(2, "cpu")), one)


def test_search_baryons_halo_across_box_face():
    """A halo wrapped around a corner of a periodic box: minimum-image
    separations, ids equal; the open box assigns fewer."""
    rng = np.random.default_rng(4)
    box = 10.0
    c = np.array([0.02, 9.97, 0.01])
    pos_dm = np.mod(np.concatenate([c + rng.normal(0, 0.1, (1500, 3)),
                                    rng.uniform(0, box, (500, 3))]), box)
    vel_dm = rng.normal(0, 50, (2000, 3))
    pfof_dm = np.concatenate([np.ones(1500, np.int32),
                              np.zeros(500, np.int32)])
    pos_b = np.mod(c + rng.normal(0, 0.1, (400, 3)), box)
    vel_b = rng.normal(0, 50, (400, 3))
    args = tuple(a.astype(np.float32) for a in (pos_dm, vel_dm)) + \
        (pfof_dm,) + tuple(a.astype(np.float32) for a in (pos_b, vel_b))
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.25
    want, got = _both(opt, *args, boxsize=box)
    np.testing.assert_array_equal(got, want)
    want_open, got_open = _both(opt, *args, boxsize=None)
    np.testing.assert_array_equal(got_open, want_open)
    assert (want > 0).sum() > (want_open > 0).sum() > 0


# ---------------------------------------------------------------------------
# find_structures and the CLI on a small hydro mock
# ---------------------------------------------------------------------------

BOX = 10.0


def hydro_mock(seed=7, halos=((3.0, 1500), (9.95, 1000)), nbg=6000):
    """Two halos (one across a box face), a quarter as much gas and an
    eighth as many stars in each, a DM background; unequal masses and all
    four hydro fields."""
    rng = np.random.default_rng(seed)
    pp, vv, tt = [], [], []
    for c, n in halos:
        Rh = 0.25
        sig = math.sqrt(G * n / Rh) * 0.25
        for cnt, fr, fv, t in ((n, 1.0, 1.0, 1), (n // 4, 0.8, 0.8, 0),
                               (n // 8, 0.5, 0.8, 4)):
            r = fr * Rh * rng.random(cnt) ** (1 / 3)
            d = rng.normal(size=(cnt, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            pp.append(np.full(3, c) + d * r[:, None])
            vv.append(rng.normal(0, sig * fv, (cnt, 3)))
            tt.append(np.full(cnt, t, np.int8))
    pp.append(rng.random((nbg, 3)) * BOX)
    vv.append(rng.normal(0, 500.0, (nbg, 3)))
    tt.append(np.full(nbg, 1, np.int8))
    pos = np.mod(np.concatenate(pp), BOX).astype(np.float32)
    vel = np.concatenate(vv).astype(np.float32)
    ptype = np.concatenate(tt)
    n = len(pos)
    mass = np.where(ptype == 1, 1.0, 0.6).astype(np.float32)
    extras = {
        "u": rng.uniform(10, 100, n).astype(np.float32),
        "sfr": np.where(rng.random(n) < 0.5, 1.0, 0.0).astype(np.float32),
        "zmet": rng.uniform(0, 0.03, n).astype(np.float32),
        "tage": rng.uniform(0, 10, n).astype(np.float32)}
    return pos, vel, mass, ptype, extras


def hydro_options(n, **over):
    """tests/test_baryons.py:127-139: FOF3D, MinSize 32, unbinding,
    Baryon_searchflag=1, all particle types."""
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = BOX / n ** (1 / 3)
    opt.fofbgtype = C.FOF3D
    opt.MinSize = 32
    opt.uinfo.unbindflag = 1
    opt.uinfo.Eratio = 1.0
    opt.G = G
    opt.iSubSearch = 0
    opt.iBaryonSearch = 1
    opt.partsearchtype = C.PSTALL
    opt.icosmologicalin = 0
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


@pytest.fixture(scope="module")
def mock():
    return hydro_mock()


CASES = {"exclusive": dict(), "inclusive2": dict(iInclusiveHalo=2),
         "halominsize": dict(HaloMinSize=32, MinSize=1400, iBoundHalos=1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_find_structures_baryon_mode_matches_reference(mock, case):
    """The DM-subset search, the association, the combined unbind (down
    to MinSize whatever HaloMinSize the field unbind used) and the
    per-type properties; Inclusive_halo_masses=2 reads the group id map
    composed through both renumberings."""
    pos, vel, mass, ptype, extras = mock
    over = CASES[case]
    want = JP.find_structures(hydro_options(len(pos), **over), pos, vel,
                              mass, boxsize=BOX, ptype=ptype, extras=extras)
    got = TP.find_structures(convert.options(hydro_options(len(pos), **over)),
                             pos, vel, mass, boxsize=BOX, ptype=ptype,
                             extras=extras, device="cpu")
    assert got.ngroups == want.ngroups >= (1 if case == "halominsize"
                                           else 2)
    assert got.pfof.dtype == np.int32
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    baryon = ptype != C.DARKTYPE
    assert (got.pfof[baryon] > 0).sum() > 0.25 * (ptype == 0).sum()
    for name in ("stype", "parent", "hostid", "hierarchy_level", "pfof3d"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    W0, W1 = np.asarray(want.W, np.float64), got.W.astype(np.float64)
    nz = W0 != 0
    assert np.array_equal(W1[~nz], W0[~nz])
    assert np.max(np.abs(W1[nz] - W0[nz]) / np.abs(W0[nz])) < 1e-4
    assert_props_match(got.props, want.props, got.ngroups)
    for k in ("n_gas", "M_star", "Temp_mean_gas", "SFR_gas", "Zmet_star",
              "t_mean_star", "M_gas_sf", "n_interloper", "q_gas"):
        assert k in got.props, k
    assert got.props["n_gas"][1] > 0 and got.props["n_star"][1] > 0
    assert {"fof", "baryons", "properties"} <= set(got.timings)
    if case == "halominsize":
        # the field unbind kept the second halo (HaloMinSize); with its
        # baryons it has fewer than MinSize members and the combined
        # unbind dissolved it
        assert "unbind" in got.timings and got.ngroups == 1
    if case == "inclusive2":
        assert "so" in got.timings and "gM200c_excl" in got.props


def test_search_and_unbind_baryon_mode(mock):
    """The tensor entry point runs the same hydro stages, and refuses
    iKeepFOF with a baryon search (the reference fails on it)."""
    pos, vel, mass, ptype, extras = mock
    opt = convert.options(hydro_options(len(pos)))
    res = TP.search_and_unbind(opt, pos, vel, mass, boxsize=BOX,
                               device="cpu", ptype=ptype)
    cat = TP.find_structures(opt, pos, vel, mass, boxsize=BOX, device="cpu",
                             ptype=ptype, extras=extras)
    np.testing.assert_array_equal(res.pfof.numpy(), cat.pfof)
    assert res.pfof.shape == (len(pos),) and res.W.shape == (len(pos),)
    assert set(res.timings) == {"fof", "baryons"}
    # every particle kept in a group is bound after the combined unbind
    # (CM frame from the returned catalog, Eratio = 1)
    g = cat.pfof.astype(np.int64)
    dv = vel - cat.props["gcmvel"][g]
    E = 0.5 * mass * (dv ** 2).sum(1) + cat.W
    assert (E[g > 0] < 0).all()
    keep = convert.options(hydro_options(len(pos), iKeepFOF=1,
                                         fofbgtype=C.FOF6D))
    with pytest.raises(NotImplementedError):
        TP.search_and_unbind(keep, pos, vel, mass, boxsize=BOX,
                             device="cpu", ptype=ptype)


OVERRIDES = """
Physical_linking_length=0.2
Halo_3D_linking_length=0.2
FoF_Field_search_type=5
Minimum_size=32
Search_for_substructure=0
Bound_halos=0
Allowed_kinetic_potential_ratio=1.0
Iterate_cm_flag=0
Binary_output=0
Baryon_searchflag=1
Particle_search_type=1
Cosmological_input=0
"""


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, mock):
    pos, vel, mass, ptype, _ = mock
    d = tmp_path_factory.mktemp("hydrocli")
    snap = str(d / "snap.gdt")
    gadget.write_gadget(snap, pos, vel, np.arange(1, len(pos) + 1), ptype,
                        mass, boxsize=BOX, time=1.0, omega0=0.3,
                        omega_lambda=0.7, hubble=1.0)
    cfg = d / "run.cfg"
    cfg.write_text((Path(__file__).resolve().parents[1] / CFG).read_text()
                   + OVERRIDES)

    def options(out):
        opt = C.parse_config_file(str(cfg))
        opt.fname, opt.inputtype, opt.outname = snap, C.IOGADGET, out
        C.config_check(opt, strict=True)
        # no cosmological input: the spacing is the caller's
        opt.ellxscale = BOX / len(pos) ** (1 / 3)
        return opt

    old = os.environ.get("VR_MESH")
    os.environ["VR_MESH"] = "1"        # the JAX CLI on one device
    try:
        want = jcli.run(options(str(d / "jax")))
    finally:
        if old is None:
            os.environ.pop("VR_MESH")
        else:
            os.environ["VR_MESH"] = old
    got = tcli.run(convert.options(options(str(d / "torch"))), device="cpu")
    return d, want, got


def test_cli_baryon_mode_catalog_matches_reference(cli_runs):
    d, want, got = cli_runs
    assert got.ngroups == want.ngroups >= 2
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    for ext in (".catalog_groups", ".hierarchy", ".catalog_parttypes"):
        assert (d / f"torch{ext}").read_bytes() == \
            (d / f"jax{ext}").read_bytes(), ext
    # the per-type columns reach the property file
    head_t = (d / "torch.properties").read_text().split("\n")[2].split()
    head_j = (d / "jax.properties").read_text().split("\n")[2].split()
    assert head_t == head_j
    names = [h.rsplit("(", 1)[0] for h in head_t]
    for col in ("n_gas", "M_gas", "n_star", "M_star"):
        assert col in names, col
    rows_t = np.loadtxt(d / "torch.properties", skiprows=3, ndmin=2)
    rows_j = np.loadtxt(d / "jax.properties", skiprows=3, ndmin=2)
    for col in ("n_gas", "n_star", "npart"):
        i = names.index(col)
        np.testing.assert_array_equal(rows_t[:, i], rows_j[:, i])
        assert rows_t[:, i].sum() > 0
    for col in ("M_gas", "M_star"):
        i = names.index(col)
        np.testing.assert_allclose(rows_t[:, i], rows_j[:, i], rtol=2e-3)
