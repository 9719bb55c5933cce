"""No group found: the port's find_structures, library API and CLI return
and write an empty catalog as the JAX package does (ngroups 0, pfof all
zero, one-row property arrays with the same keys, shapes and dtype kinds;
the values of row 0, the untagged particles, carry no meaning and are not
compared).
"""

from pathlib import Path

import numpy as np
import pytest

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import pipeline as JP

from velociraptor_stf_tpu_torch import api as TA
from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io import gadget
from velociraptor_stf_tpu_torch.models import pipeline as TP

from test_torch_properties import CFG, slice_options
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(case):
    """(pos, vel, mass, boxsize, n for the spacing, option overrides)."""
    if case == "one-particle":
        one = np.full((1, 3), 5.0, np.float32)
        return one, one, np.ones(1, np.float32), 10.0, 3000, {}
    if case.startswith("uniform"):
        pos = np.random.default_rng(0).uniform(0, 100, (4096, 3)).astype(
            np.float32)
        box = None if case.endswith("open") else 100.0
        return pos, pos, np.ones(4096, np.float32), box, 100 ** 3, \
            dict(ellphys=0.01)
    # groups exist, but none as large as HaloMinSize
    pos, vel, mass = make_cosmo_mock(1 << 13, boxsize=20.0, nhalos=6, seed=3)
    return pos, vel, mass, 20.0, 1 << 13, dict(HaloMinSize=1 << 13)


def _options(case, **extra):
    _, _, _, _, n, over = _inputs(case)
    return slice_options(100.0 if case.startswith("uniform") else 20.0, n,
                         **over, **extra)


@pytest.mark.parametrize("inclusive", [0, 3], ids=["exclusive", "so"])
@pytest.mark.parametrize("case", ["one-particle", "uniform", "uniform-open",
                                  "halominsize"])
def test_find_structures_without_groups_matches_reference(case, inclusive):
    pos, vel, mass, box, _, _ = _inputs(case)
    want = JP.find_structures(_options(case, iInclusiveHalo=inclusive), pos,
                              vel, mass, boxsize=box)
    got = TP.find_structures(
        convert.options(_options(case, iInclusiveHalo=inclusive)), pos, vel,
        mass, boxsize=box, device="cpu")
    assert got.ngroups == want.ngroups == 0
    assert got.pfof.dtype == np.int32 and got.pfof.shape == (len(pos),)
    assert not got.pfof.any() and not np.asarray(want.pfof).any()
    assert set(got.props) == set(want.props)
    for k, w in want.props.items():
        g, w = got.props[k], np.asarray(w)
        assert g.shape == w.shape and g.shape[0] == 1, k
        assert g.dtype.kind == w.dtype.kind, k
    for name in ("W", "hostid", "parent", "hierarchy_level", "so_offsets",
                 "so_indices", "stype"):
        assert (getattr(got, name) is None) == \
            (getattr(want, name) is None), name
    assert "properties" in got.timings and "so" not in got.timings


def test_library_api_without_groups(tmp_path):
    pos, vel, mass, box, n, over = _inputs("uniform")
    session = TA.VelociraptorSession(
        opt=convert.options(_options("uniform")))
    out = session.invoke(
        pos, vel, mass, pids=np.arange(1, len(pos) + 1),
        sim=TA.SimInfo(period=box, interparticlespacing=1.0),
        outname=str(tmp_path / "cat"), write_output=True, device="cpu")
    assert out["ngroups"] == 0 and not out["group_id"].any()
    assert out["properties"]["num"].shape == (1,)
    for ext in (".properties", ".catalog_groups", ".catalog_particles"):
        assert (tmp_path / f"cat{ext}").exists(), ext


def test_cli_writes_empty_catalog(tmp_path):
    """The CLI on a snapshot without a group: every catalog file is
    written and holds zero groups."""
    pos, vel, mass, box, _, _ = _inputs("uniform")
    snap = str(tmp_path / "snap.gdt")
    gadget.write_gadget(snap, pos, vel, np.arange(1, len(pos) + 1),
                        np.ones(len(pos), np.int8), mass, boxsize=box,
                        time=1.0, omega0=0.3, omega_lambda=0.7, hubble=1.0)
    cfg = tmp_path / "run.cfg"
    cfg.write_text((Path(__file__).resolve().parents[1] / CFG).read_text() +
                   "\nSearch_for_substructure=0\nBinary_output=0\n"
                   "Physical_linking_length=0.01\nBound_halos=1\n")
    out = str(tmp_path / "cat")
    assert tcli.main(["-C", str(cfg), "-i", snap, "-o", out, "--device",
                      "cpu"]) == 0
    groups = Path(out + ".catalog_groups").read_text().split("\n")
    assert groups[1].split() == ["0", "0"]
    assert len(Path(out + ".properties").read_text().strip().split("\n")) == 3
    for ext in (".catalog_particles", ".catalog_particles.unbound",
                ".hierarchy", ".profiles", ".configuration"):
        assert Path(out + ext).exists(), ext
