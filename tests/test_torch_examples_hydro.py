"""The hydro configs under examples/ with a 6DFOF field search through
the port's CLI against the JAX package's CLI on one gadget snapshot of
dark matter and gas: the unmodified sample_eaglehydro_6dfof_subhalo.cfg
and sample_swifthydro_6dfof_subhalo.cfg (baryon search, substructure,
apertures).

Exact: pfof, hostid, parent, level and the .catalog_groups, .hierarchy
and .catalog_parttypes datasets.  Properties: assert_props_inside with
F5's tie rule.  Every config runs as shipped (eps = 0).
"""

import numpy as np
import pytest

from velociraptor_stf_tpu_torch.io.synthetic import example_snapshot

from test_torch_examples_dm import (assert_example_matches, run_both,
                                    write_snapshot)
from torch_threads import one_torch_thread  # noqa: F401

HYDRO_FILES = (".catalog_groups", ".hierarchy", ".catalog_parttypes")


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    # the planted input with gas copies of a sixth of the particles: the
    # subhalo, found as a substructure, takes gas in the association
    d = tmp_path_factory.mktemp("examples_hydro")
    pos, vel, mass, ptype = example_snapshot("hydro")
    return d, write_snapshot(d / "snap.gdt", pos, vel, mass, ptype)


@pytest.mark.parametrize("name", ["sample_eaglehydro_6dfof_subhalo.cfg",
                                  "sample_swifthydro_6dfof_subhalo.cfg"])
def test_hydro_config_matches_reference(snapshot, name):
    d, snap = snapshot
    out = d / name.split(".")[0]
    out.mkdir()
    want, got, opt = run_both(name, snap, out)
    assert opt.iBaryonSearch >= 1 and opt.iSubSearch == 1
    assert opt.uinfo.eps == 0.0
    ptype = assert_example_matches(out, want, got, opt, HYDRO_FILES)
    subs = np.nonzero(got.parent[1:] > 0)[0] + 1
    assert np.isin(got.pfof[ptype == 0], subs).any(), \
        "no gas associated with a substructure"
    assert "baryons" in got.timings and "substructure" in got.timings
