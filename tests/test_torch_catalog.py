"""The port's find_structures and CLI (velociraptor_stf_tpu_torch.models.
pipeline.find_structures, velociraptor_stf_tpu_torch.cli) against the JAX
package's on the same mock and the same gadget snapshot.

Exact: group ids, group count, structure types, hierarchy, SO particle
lists, the .catalog_groups and .hierarchy files and each group's particle
set.  Potentials within rel 1e-4.  Properties and .properties columns with
the tolerances of tests/test_torch_properties.py.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from velociraptor_stf_tpu import cli as jcli
from velociraptor_stf_tpu.io import gadget
from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import pipeline as JP
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import pipeline as TP

from test_torch_properties import (CFG, assert_props_match, newton_settled,
                                   slice_options)
from torch_threads import one_torch_thread  # noqa: F401

BOX, N = 32.0, 1 << 15
# the bench's search options over the sample config, ASCII catalogs
OVERRIDES = """
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


@pytest.fixture(scope="module")
def mock():
    return make_cosmo_mock(N, boxsize=BOX, nhalos=60, seed=9)


CASES = {"slice": dict(iSphericalOverdensityPartList=1),
         "inclusive2": dict(iInclusiveHalo=2),
         "keepfof": dict(iKeepFOF=1)}


def _equal_or_none(got, want, name):
    assert (got is None) == (want is None), name
    if want is not None:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_find_structures_matches_reference(mock, case):
    pos, vel, mass = mock
    want = JP.find_structures(slice_options(BOX, N, **CASES[case]), pos,
                              vel, mass, boxsize=BOX)
    got = TP.find_structures(
        convert.options(slice_options(BOX, N, **CASES[case])), pos, vel, mass,
        boxsize=BOX, device="cpu")
    assert got.ngroups == want.ngroups > 0
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    _equal_or_none(got.pfof3d, want.pfof3d, "pfof3d")
    for name in ("stype", "parent", "hostid", "hierarchy_level",
                 "so_offsets", "so_indices"):
        _equal_or_none(getattr(got, name), getattr(want, name), name)
    if case == "slice":
        assert got.so_offsets[-1] > 0
    if case == "keepfof":
        assert (got.stype == C.FOF3DTYPE).sum() > 0 and got.W is None
    else:
        W0, W1 = np.asarray(want.W, np.float64), got.W.astype(np.float64)
        nz = W0 != 0
        assert np.array_equal(W1[~nz], W0[~nz])
        assert np.max(np.abs(W1[nz] - W0[nz]) / np.abs(W0[nz])) < 1e-4
    assert_props_match(got.props, want.props, got.ngroups)
    assert {"fof", "properties", "so"} <= set(got.timings)


def test_hierarchy_remap_matches_reference():
    """Old -> new group id maps applied to a random hierarchy, dissolved
    groups and out-of-range ids included."""
    rng = np.random.default_rng(0)
    ng_old, ng_new = 40, 25
    gid_map = np.zeros(ng_old + 1, np.int64)
    gid_map[1 + rng.permutation(ng_old)[:ng_new]] = np.arange(1, ng_new + 1)
    parent = rng.integers(0, ng_old + 3, ng_old + 1)
    hostid = np.where(rng.random(ng_old + 1) < 0.3, -1, parent)
    level = rng.integers(0, 3, ng_old + 1).astype(np.int32)
    want = JP._remap_hierarchy(gid_map, ng_new, hostid, parent, level)
    got = TP._remap_hierarchy(gid_map, ng_new, hostid, parent, level)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(TP._map_gids(gid_map, parent, -7),
                                  JP._map_gids(gid_map, parent, -7))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory, mock):
    pos, vel, mass = mock
    d = tmp_path_factory.mktemp("cli")
    fn = str(d / "snap.gdt")
    gadget.write_gadget(fn, pos, vel, np.arange(1, len(pos) + 1),
                        np.ones(len(pos), np.int8), mass, boxsize=BOX,
                        time=1.0, omega0=0.3, omega_lambda=0.7, hubble=1.0)
    cfg = d / "run.cfg"
    cfg.write_text((Path(__file__).resolve().parents[1] / CFG).read_text()
                   + OVERRIDES)
    return d, fn, str(cfg)


def _cli_options(cfg, snap, out):
    """Options as both CLIs' main() makes them."""
    opt = C.parse_config_file(cfg)
    opt.fname, opt.inputtype, opt.outname = snap, C.IOGADGET, out
    C.config_check(opt, strict=True)
    return opt


@pytest.fixture(scope="module")
def cli_runs(snapshot):
    d, snap, cfg = snapshot
    old = os.environ.get("VR_MESH")
    os.environ["VR_MESH"] = "1"        # the JAX CLI on one device
    try:
        want = jcli.run(_cli_options(cfg, snap, str(d / "jax")))
    finally:
        if old is None:
            os.environ.pop("VR_MESH")
        else:
            os.environ["VR_MESH"] = old
    got = tcli.run(convert.options(_cli_options(cfg, snap, str(d / "torch"))),
                   device="cpu")
    return d, want, got


def _read(path):
    return Path(path).read_bytes()


def _groups(d, tag):
    """Per-group particle id sets of the ASCII group catalog."""
    lines = Path(d / f"{tag}.catalog_groups").read_text().split("\n")
    ng = int(lines[1].split()[0])
    vals = np.array(lines[2:2 + 3 * ng], np.int64)
    sizes, offs = vals[:ng], vals[ng:2 * ng]
    ids = np.loadtxt(d / f"{tag}.catalog_particles", np.int64, skiprows=2,
                     ndmin=1)
    return [set(ids[o:o + s]) for o, s in zip(offs, sizes)]


def _properties(path):
    lines = Path(path).read_text().split("\n")
    names = [h.rsplit("(", 1)[0] for h in lines[2].split()]
    table = np.array([[float(x) for x in ln.split()] for ln in lines[3:]
                      if ln.strip()]).reshape(-1, len(names))
    return {k: table[:, i] for i, k in enumerate(names)}


def test_cli_catalog_files_match_reference(cli_runs):
    d, want, got = cli_runs
    assert got.ngroups == want.ngroups > 0
    for ext in (".catalog_groups", ".hierarchy"):
        assert _read(d / f"torch{ext}") == _read(d / f"jax{ext}"), ext
    assert _groups(d, "torch") == _groups(d, "jax")
    for ext in (".catalog_particles.unbound", ".profiles", ".configuration",
                ".siminfo", ".units"):
        assert (d / f"torch{ext}").exists(), ext


def test_cli_properties_match_reference(cli_runs):
    d, want, got = cli_runs
    ng = got.ngroups
    cw, cg = _properties(d / "jax.properties"), _properties(
        d / "torch.properties")
    assert list(cg) == list(cw)
    stable = (np.asarray(got.props["RVmax_npart"]) ==
              np.asarray(want.props["RVmax_npart"]))[1:ng + 1]
    settled = newton_settled(want.props["VmaxVvir2"])[1:ng + 1]
    exact = ("ID", "ID_mbp", "ID_minpot", "hostHaloID", "numSubStruct",
             "npart", "Structuretype")
    for k in cw:
        g, w = cg[k], cw[k]
        if k.startswith("RVmax_"):
            g, w = g[stable], w[stable]
        if k == "cNFW":
            g, w = g[settled], w[settled]
        if k in exact or k.startswith("Aperture_npart"):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        if "eig_" in k:      # up to the sign of each eigenvector
            pre, ab = k.rsplit("_", 1)
            vec = np.stack([cg[f"{pre}_{a}{ab[1]}"] for a in "xyz"], 1)
            ref = np.stack([cw[f"{pre}_{a}{ab[1]}"] for a in "xyz"], 1)
            sign = np.sign(np.sum(vec * ref, 1))
            g = g * np.where(sign == 0, 1.0, sign)[stable if
                                                  k.startswith("RVmax_")
                                                  else slice(None)]
        scale = np.abs(w).max(initial=0.0)
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=2e-3 * max(scale, 1e-30),
                                   err_msg=k)


def test_cli_main_writes_catalog(snapshot, tmp_path):
    """python -m velociraptor_stf_tpu_torch.cli on the CPU."""
    _, snap, cfg = snapshot
    out = str(tmp_path / "cat")
    rc = tcli.main(["-C", cfg, "-i", snap, "-I", "1", "-o", out,
                    "--device", "cpu"])
    assert rc == 0
    for ext in (".properties", ".catalog_groups", ".catalog_particles",
                ".hierarchy", ".profiles"):
        assert os.path.exists(out + ext), ext


def test_cli_refuses_missing_card(snapshot, tmp_path, monkeypatch):
    """--device cuda without a card exits non-zero, before any work."""
    _, snap, cfg = snapshot
    monkeypatch.setattr(tcli.torch.cuda, "is_available", lambda: False)
    assert tcli.main(["-C", cfg, "-i", snap, "-o",
                      str(tmp_path / "x")]) != 0
    assert not (tmp_path / "x.properties").exists()
