"""The substructure catalog through the port's entry points: the frozen
golden catalog (made with ``iSubSearch = 1``) through the port's
find_structures must pass the JAX package's golden gate
(tests/test_golden.py), and the port's CLI on the unmodified
examples/sample_dmcosmological_run.cfg (substructure search, merger-core
search, HDF5 catalogs) against the JAX CLI on the same gadget snapshot:
the .catalog_groups and .hierarchy datasets exactly equal, the
properties within the golden tolerance.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from velociraptor_stf_tpu import cli as jcli
from velociraptor_stf_tpu.io import gadget
from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import pipeline as TP
from velociraptor_stf_tpu_torch.utils import telemetry

from test_golden import (GOLDEN, _golden_options, _match_fraction,
                         _partition)
from test_torch_subcatalog import assert_props_inside, half_mass_ties
from torch_threads import one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "sample_dmcosmological_run.cfg"


def test_golden_catalog_through_port():
    """tests/test_golden.py's gate: the same group count, >= 0.999 of
    the members matched both ways, gmass/gM200c/gR200c/gsize within rtol
    5e-4 and parent exactly equal."""
    with np.load(GOLDEN) as z:
        pos, vel, mass = z["pos"], z["vel"], z["mass"]
        boxsize = float(z["boxsize"])
        want = {k: z[k] for k in ("pfof", "ngroups", "gmass", "gM200c",
                                  "gR200c", "gsize", "parent")}
    opt = convert.options(_golden_options(boxsize, len(pos)))
    assert opt.iSubSearch == 1
    res = TP.find_structures(opt, pos, vel, mass, boxsize=boxsize,
                             device="cpu")
    assert res.ngroups == int(want["ngroups"])
    pa, pb = _partition(res.pfof), _partition(want["pfof"])
    assert _match_fraction(pa, pb) >= 0.999
    assert _match_fraction(pb, pa) >= 0.999
    ng = res.ngroups
    for k in ("gmass", "gM200c", "gR200c", "gsize"):
        np.testing.assert_allclose(res.props[k][:ng + 1],
                                   want[k][:ng + 1], rtol=5e-4, err_msg=k)
    np.testing.assert_array_equal(res.parent, want["parent"])
    assert "substructure" in res.timings


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs on one gadget snapshot with the unmodified sample
    config (the JAX CLI on one device)."""
    d = tmp_path_factory.mktemp("subcli")
    n, box = 1 << 15, 20.0
    pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=8, seed=31)
    snap = str(d / "snap.gdt")
    gadget.write_gadget(snap, pos, vel, np.arange(1, n + 1),
                        np.ones(n, np.int8), mass, boxsize=box, time=1.0,
                        omega0=0.3, omega_lambda=0.7, hubble=0.7)

    def options(out):
        opt = C.parse_config_file(str(EXAMPLE))
        opt.fname, opt.inputtype, opt.outname = snap, C.IOGADGET, out
        C.config_check(opt, strict=True)
        return opt

    old = os.environ.get("VR_MESH")
    os.environ["VR_MESH"] = "1"
    try:
        want = jcli.run(options(str(d / "jax")))
    finally:
        if old is None:
            os.environ.pop("VR_MESH")
        else:
            os.environ["VR_MESH"] = old
    telemetry.reset()
    got = tcli.run(convert.options(options(str(d / "torch"))), device="cpu")
    return d, want, got, telemetry.snapshot()


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def test_cli_example_config_matches_reference(cli_runs):
    d, want, got, counts = cli_runs
    assert got.ngroups == want.ngroups > 0
    # every structure searched goes through the batched subset search
    searched = sum(v for k, v in counts.items()
                   if k.startswith("subsub_level") and
                   k.endswith("_structures"))
    assert searched > 0 and counts["subset_batches"] >= 1
    assert counts["subset_batched_particles"] >= searched * 1024
    assert got.parent is not None and got.timings["subsub_subset"] > 0
    for ext in (".catalog_groups", ".hierarchy"):
        g, w = _datasets(d / f"torch{ext}"), _datasets(d / f"jax{ext}")
        assert sorted(g) == sorted(w), ext
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{ext} {k}")
    np.testing.assert_array_equal(got.pfof, want.pfof)
    for k in ("hostid", "parent", "hierarchy_level"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    opt = convert.options(C.parse_config_file(str(EXAMPLE)))
    opt.fname, opt.inputtype = str(d / "snap.gdt"), C.IOGADGET
    pos, _, _, _, mass, box, _ = tcli.read_snapshot(opt)
    ties = half_mass_ties(opt, want.props, pos, mass, got.pfof, W=want.W,
                          boxsize=box)
    assert_props_inside(got.props, want.props, got.ngroups, ties=ties)
    assert "substructure" in got.timings


def test_cli_density_cache_passes_through(cli_runs, tmp_path):
    """``Output_den`` reaches the recursion through the port's CLI: the
    first run writes the velocity-density cache, the second replays it
    and writes the same catalog."""
    d, _, got, _ = cli_runs
    cfg = tmp_path / "den.cfg"
    cache = tmp_path / "run.localden"
    cfg.write_text(EXAMPLE.read_text() + f"\nOutput_den={cache}\n")
    outs = []
    for k in range(2):
        out = str(tmp_path / f"den{k}")
        assert tcli.main(["-C", str(cfg), "-i", str(d / "snap.gdt"),
                          "-I", "1", "-o", out, "--device", "cpu"]) == 0
        outs.append(_datasets(out + ".catalog_groups"))
        assert (tmp_path / "run.localden.npz").exists()
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    ref = _datasets(d / "torch.catalog_groups")
    for k in ref:
        np.testing.assert_array_equal(outs[0][k], ref[k], err_msg=k)
