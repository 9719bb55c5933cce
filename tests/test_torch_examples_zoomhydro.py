"""sample_zoomhydrocosmological_run.cfg through the port's CLI against
the JAX package's CLI on a zoom snapshot (dark matter, gas and
low-resolution type-2 particles), and sample_swifthydro_3dfof_subhalo.cfg
through the library API on both sides (the SWIFT route, as
tests/test_examples.py:105 runs it), both unmodified (eps = 0).

Exact: pfof, hostid, parent, level and the .catalog_groups, .hierarchy
and .catalog_parttypes datasets.  Properties: assert_props_inside with
F5's tie rule.
"""

import numpy as np

from velociraptor_stf_tpu import api as japi
from velociraptor_stf_tpu_torch import api as tapi
from velociraptor_stf_tpu_torch.io.synthetic import example_snapshot
from velociraptor_stf_tpu_torch.utils import config as TC

from test_torch_examples_dm import (BOX, EXAMPLES, assert_example_matches,
                                    one_device, run_both, write_snapshot)
from test_torch_examples_hydro import HYDRO_FILES
from test_torch_subcatalog import assert_props_inside, half_mass_ties
from test_torch_subcli import _datasets
from torch_threads import one_torch_thread  # noqa: F401


def test_zoomhydro_config_matches_reference(tmp_path):
    # the hydro input with 256 uniform low-resolution particles and eight
    # inside the host: some stay in a group as interlopers
    pos, vel, mass, ptype = example_snapshot("zoom")
    snap = write_snapshot(tmp_path / "snap.gdt", pos, vel, mass, ptype)
    name = "sample_zoomhydrocosmological_run.cfg"
    want, got, opt = run_both(name, snap, tmp_path)
    assert opt.iBaryonSearch >= 1 and opt.uinfo.eps == 0.0
    ptype = assert_example_matches(tmp_path, want, got, opt, HYDRO_FILES)
    subs = np.nonzero(got.parent[1:] > 0)[0] + 1
    assert np.isin(got.pfof[ptype == 0], subs).any()
    assert (got.pfof[ptype == 2] > 0).any(), "no interloper in a group"
    assert (got.props["n_interloper"][1:] > 0).any()


def test_swifthydro_3dfof_config_through_api(tmp_path):
    pos, vel, mass, ptype = example_snapshot("hydro")
    n = len(pos)
    pids = np.arange(1, n + 1)
    cfg = str(EXAMPLES / "sample_swifthydro_3dfof_subhalo.cfg")
    out = {}
    for tag, api in (("jax", japi), ("torch", tapi)):
        s = api.VelociraptorSession(config=cfg)
        kw = {} if tag == "jax" else {"device": "cpu"}
        sim = api.SimInfo(period=BOX, interparticlespacing=BOX / n ** (1 / 3),
                          icosmologicalsim=1)
        with one_device():
            out[tag] = s.invoke(pos, vel, mass, pids=pids, ptype=ptype,
                                sim=sim, outname=str(tmp_path / tag),
                                write_output=True, **kw)
        out[tag + "_opt"] = s.opt
    want, got = out["jax"], out["torch"]
    opt = out["torch_opt"]
    assert opt.iBaryonSearch >= 1 and opt.iBoundHalos == 0
    assert got["ngroups"] == want["ngroups"] > 0
    for k in ("group_id", "hostid", "parent"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    # the API writes the catalogs and properties, no hierarchy
    for ext in (".catalog_groups", ".catalog_particles",
                ".catalog_parttypes"):
        g, w = _datasets(tmp_path / f"torch{ext}"), \
            _datasets(tmp_path / f"jax{ext}")
        assert sorted(g) == sorted(w), ext
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{ext} {k}")
    ties = half_mass_ties(opt, want["properties"], pos, mass,
                          got["group_id"], vel=vel, ptype=ptype, boxsize=BOX)
    assert_props_inside(got["properties"], want["properties"],
                        got["ngroups"], ties=ties)
    subs = np.nonzero(got["parent"][1:] > 0)[0] + 1
    assert len(subs) >= 1
    assert np.isin(got["group_id"][ptype == 0], subs).any()
    assert opt.iPropertyReferencePosition == TC.PROPREFCM
