"""``VR_PROFILE=<dir>`` in the port's CLI (velociraptor_stf_tpu_torch/
utils/timing.py::profile_trace, the JAX CLI's jax.profiler trace on
``torch.profiler``): a Chrome trace of the search lands in the directory;
without the variable the context does nothing.
"""

import json
from pathlib import Path

import numpy as np
import torch

from velociraptor_stf_tpu_torch import cli as tcli
from velociraptor_stf_tpu_torch.io import gadget
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch.utils.timing import profile_trace

from torch_threads import one_torch_thread  # noqa: F401

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "sample_dmcosmological_run.cfg"


def test_profile_trace_is_a_no_op_without_a_directory(tmp_path):
    with profile_trace(None):
        x = torch.ones(4).sum()
    assert float(x) == 4.0
    with profile_trace(str(tmp_path / "t")):
        torch.arange(8).cumsum(0)
    (trace,) = (tmp_path / "t").glob("*.json")
    assert "traceEvents" in json.loads(trace.read_text())


def test_cli_writes_a_trace_under_vr_profile(tmp_path, monkeypatch):
    """The CLI on a small snapshot with ``VR_PROFILE`` set: one trace file
    whose events include the search's operators, and the catalog."""
    n, box = 4096, 10.0
    pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=4, seed=3)
    snap = str(tmp_path / "snap.gdt")
    gadget.write_gadget(snap, pos, vel, np.arange(1, n + 1),
                        np.ones(n, np.int8), mass, boxsize=box, time=1.0,
                        omega0=0.3, omega_lambda=0.7, hubble=0.7)
    cfg = tmp_path / "run.cfg"
    cfg.write_text(EXAMPLE.read_text() + "\nFoF_Field_search_type=5\n"
                   "Search_for_substructure=0\nBinary_output=1\n")
    prof = tmp_path / "prof"
    monkeypatch.setenv("VR_PROFILE", str(prof))
    monkeypatch.delenv("VR_MESH", raising=False)
    out = str(tmp_path / "out")
    assert tcli.main(["-C", str(cfg), "-i", snap, "-I", "1", "-o", out,
                      "--device", "cpu"]) == 0
    (trace,) = prof.glob("*.json")
    names = {e.get("name", "") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert any(k.startswith("aten::") for k in names)
    assert (tmp_path / "out.catalog_groups").exists()
