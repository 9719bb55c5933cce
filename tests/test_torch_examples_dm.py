"""The dark-matter configs under examples/ through the port's CLI against
the JAX package's CLI on one gadget snapshot: the unmodified
sample_dmcosmological_run.cfg and genesis2019_configuration.cfg (adaptive
6DFOF, Bound_halos=0, Inclusive_halo_masses=2), and the refusal of
sample_zoom_run.cfg by both.

Exact: pfof, hostid, parent, level and the .catalog_groups and .hierarchy
datasets.  Properties: tests/test_torch_subcatalog.py::assert_props_inside
with F5's tie rule (``half_mass_ties``).  Every config runs as shipped,
``Softening_length`` unset (eps = 0).  The helpers here serve
tests/test_torch_examples_hydro.py too.
"""

import contextlib
import math
import os
from pathlib import Path

import numpy as np
import pytest

from velociraptor_stf_tpu import cli as jcli
from velociraptor_stf_tpu.io import gadget
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import (EXAMPLE_BOXSIZE as BOX,
                                                     example_snapshot)
from velociraptor_stf_tpu_torch.models import pipeline as TP

from test_torch_subcatalog import assert_props_inside, half_mass_ties
from test_torch_subcli import _datasets
from torch_threads import one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def write_snapshot(path, pos, vel, mass, ptype):
    gadget.write_gadget(str(path), pos, vel, np.arange(1, len(pos) + 1),
                        ptype, mass, boxsize=BOX, time=1.0, omega0=0.3,
                        omega_lambda=0.7, hubble=0.7)
    return str(path)


def example_options(name, snap, out):
    """The shipped config as the CLI reads it, on ``snap``."""
    opt = C.parse_config_file(str(EXAMPLES / name))
    opt.fname, opt.inputtype, opt.outname = snap, C.IOGADGET, out
    C.config_check(opt, strict=True)
    return opt


@contextlib.contextmanager
def one_device():
    """The JAX CLI on one device (it shards over the 8 virtual CPU
    devices otherwise); restores VR_MESH on exit."""
    old = os.environ.get("VR_MESH")
    os.environ["VR_MESH"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VR_MESH")
        else:
            os.environ["VR_MESH"] = old


def run_both(name, snap, d):
    """(JAX result, port result, port options) of both CLIs' runs."""
    with one_device():
        want = jcli.run(example_options(name, snap, str(d / "jax")))
    topt = convert.options(example_options(name, snap, str(d / "torch")))
    got = tcli.run(topt, device="cpu")
    return want, got, topt


def assert_example_matches(d, want, got, opt, files):
    """Exact ids, hierarchy and catalog ``files``; properties within
    assert_props_inside with F5's rule, the tied rows found on the
    snapshot as the CLI read it."""
    assert got.ngroups == want.ngroups > 0
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    for k in ("hostid", "parent", "hierarchy_level"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)), k)
    for ext in files:
        g, w = _datasets(d / f"torch{ext}"), _datasets(d / f"jax{ext}")
        assert sorted(g) == sorted(w), ext
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{ext} {k}")
    pos, vel, _, ptype, mass, box, _ = tcli.read_snapshot(opt)
    W = None if want.W is None else np.asarray(want.W)
    ties = half_mass_ties(opt, want.props, pos, mass, got.pfof, W=W,
                          vel=vel, ptype=ptype if len(set(ptype)) > 1
                          else None, boxsize=box, got=got.props)
    overflow = None
    if opt.iInclusiveHalo in (1, 2):
        sres = TP.search_and_unbind(opt, pos, vel, mass, boxsize=box,
                                    device="cpu")
        overflow = inclusive_so_overflow(opt, pos, mass,
                                         sres.pfof_fof.numpy(),
                                         sres.ngroups_fof, box, got.ngroups)
        # the inclusive pass writes field halos only
        for cells in overflow.values():
            rows = np.nonzero(cells.reshape(len(cells), -1).any(1))[0]
            assert (np.asarray(got.hostid)[rows] == -1).all()
    assert_props_inside(got.props, want.props, got.ngroups, ties=ties,
                        overflow=overflow)
    return ptype


def inclusive_so_overflow(opt, pos, mass, pfof_fof, ng_fof, boxsize, ng):
    """A float64 oracle of Inclusive_halo_masses 1/2's SO pass (both
    packages' compute_properties on the field search's ids, about each
    group's centre of mass, minimum count 0.05 num + 1): the cells
    {key: (ng+1,) or (ng+1, nSO) bool} whose value lies beyond float32's
    range.  Where a group's first sample past the minimum count is
    already below a threshold, the crossing extrapolates the log-log
    enclosed density outward from the previous sample; when the two
    densities are nearly equal the slope is huge and the exp() of the
    extrapolation overflows, in the reference as in the port."""
    lnthr = [math.log(max((opt.virlevel if opt.virlevel > 0 else 200.0) *
                          opt.rhobg, 1e-30)),
             math.log(opt.rhocrit * 200.0), math.log(opt.rhobg * 200.0),
             math.log(opt.rhocrit * 500.0),
             math.log(max(opt.virBN98 * opt.rhocrit, 1e-30))] + \
        [math.log(opt.rhocrit * t) for t in opt.SOthresholds_values_crit]
    names = [("gMvir", "gRvir"), ("gM200c", "gR200c"), ("gM200m", "gR200m"),
             ("gM500c", "gR500c"), ("gMBN98", "gRBN98")]
    nso = len(opt.SOthresholds_values_crit)
    out = {k: np.zeros(ng + 1, bool) for pair in names for k in pair}
    out.update(SO_mass=np.zeros((ng + 1, nso), bool),
               SO_radius=np.zeros((ng + 1, nso), bool))
    big = math.log(float(np.finfo(np.float32).max))
    for g in range(1, min(ng_fof, ng) + 1):
        mem = np.nonzero(pfof_fof == g)[0]
        x = pos[mem].astype(np.float64)
        d = x - x[0]
        x = x[0] + d - boxsize * np.round(d / boxsize)
        m = mass[mem].astype(np.float64)
        cm = (x * m[:, None]).sum(0) / m.sum()
        r = np.sqrt(np.maximum(((x - cm) ** 2).sum(1), 1e-30))
        srt = np.argsort(r, kind="stable")
        r, M = r[srt], np.cumsum(m[srt])
        lnrho = np.log(M) - 3.0 * np.log(r) + math.log(3.0 / (4.0 * math.pi))
        minnum = max(int(0.05 * len(mem) + 1), int(opt.MinSize * 0.05 + 1))
        for i, thr in enumerate(lnthr):
            k = np.nonzero((lnrho < thr) & (np.arange(len(r)) >= minnum))[0]
            if not len(k):
                continue
            k = k[0]
            p = max(k - 1, 0)
            drho = lnrho[k] - lnrho[p]
            if abs(drho) <= 1e-12:
                continue
            delta = thr - lnrho[k]
            logs = (np.log(M[k]) + np.log(M[k] / M[p]) / drho * delta,
                    np.log(r[k]) + np.log(r[k] / r[p]) / drho * delta)
            for key, v in zip(names[i] if i < 5 else ("SO_mass", "SO_radius"),
                              logs):
                if v > big:
                    if i < 5:
                        out[key][g] = True
                    else:
                        out[key][g, i - 5] = True
    return out


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples_dm")
    # example_snapshot's defaults: every config below finds its planted
    # subhalo as a substructure (asserted)
    pos, vel, mass, ptype = example_snapshot("dm")
    return d, write_snapshot(d / "snap.gdt", pos, vel, mass, ptype)


@pytest.fixture(scope="module")
def cli_runs(snapshot):
    """name -> (output directory, JAX result, port result, port
    options), each config run once per module."""
    d, snap = snapshot
    done = {}

    def get(name):
        if name not in done:
            out = d / name.split(".")[0]
            out.mkdir()
            done[name] = (out,) + run_both(name, snap, out)
        return done[name]
    return get


@pytest.mark.parametrize("name", ["sample_dmcosmological_run.cfg",
                                  "genesis2019_configuration.cfg"])
def test_example_config_matches_reference(cli_runs, name):
    d, want, got, opt = cli_runs(name)
    assert opt.uinfo.eps == 0.0                # Softening_length unset
    assert_example_matches(d, want, got, opt,
                           (".catalog_groups", ".hierarchy"))
    # the input's planted subhalo is found as a substructure
    assert (got.parent[1:] > 0).sum() >= 1
    assert "substructure" in got.timings


def test_genesis_inclusive_masses_before_the_splice(cli_runs):
    """F4's regression gate: with Bound_halos=0 and
    Inclusive_halo_masses=2 the inclusive masses come from the field
    search's ids, which the substructure splice must leave as they were
    (the port once wrote the substructure ids into them and raised)."""
    d, want, got, opt = cli_runs("genesis2019_configuration.cfg")
    assert opt.iBoundHalos == 0 and opt.iInclusiveHalo == 2
    assert opt.iSubSearch == 1 and (got.parent[1:] > 0).sum() >= 1
    pos, vel, _, _, mass, box, _ = tcli.read_snapshot(opt)
    sres = TP.search_and_unbind(opt, pos, vel, mass, boxsize=box,
                                device="cpu")
    assert sres.ngroups > sres.ngroups_fof > 0
    assert int(sres.pfof_fof.max()) <= sres.ngroups_fof
    # a substructure's particles keep their field halo's id there: the
    # top of its hierarchy, which no unbind renumbered
    pfof, fof = sres.pfof.numpy(), sres.pfof_fof.numpy()
    top = np.where(pfof > sres.ngroups_fof, np.asarray(sres.hostid)[pfof],
                   pfof)
    np.testing.assert_array_equal(top[fof > 0], fof[fof > 0])
    # the catalog's inclusive masses are those of the ids before the
    # splice (test_example_config_matches_reference holds them to the
    # JAX package's)
    assert "gM200c_excl" in got.props


def test_zoom_run_config_refused(snapshot, tmp_path):
    """sample_zoom_run.cfg sets Baryon_searchflag=1 with
    Particle_search_type=0 (gas only), which both CLIs refuse before
    reading the snapshot (config_check(strict=True), ui.cxx:764)."""
    _, snap = snapshot
    cfg = str(EXAMPLES / "sample_zoom_run.cfg")
    msg = "Baryon_searchflag requires Particle_search_type all/dark"
    args = ["-C", cfg, "-i", snap, "-I", "1", "-o", str(tmp_path / "zoom")]
    for cli, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(ValueError, match=msg):
            cli.main(args + extra)
    assert not list(tmp_path.iterdir())
