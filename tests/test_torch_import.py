"""The PyTorch port imports and runs without JAX, and without nvcc.

A subprocess is needed: tests/conftest.py imports jax into this process."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # no CUDA toolkit reachable: importing must not need one
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(
        os.pathsep) if "cuda" not in p.lower())
    env["CUDA_HOME"] = str(REPO / "no-such-cuda")
    return subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_runs_slice_without_jax():
    code = """
import sys
import numpy as np
from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu_torch.models.pipeline import search_and_unbind

n, box = 4096, 20.0
pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=6, seed=3)
opt = C.Options()
opt.ellphys = 0.2
opt.ellxscale = box / n ** (1 / 3)
opt.fofbgtype = C.FOF6D
opt.MinSize = 20
opt.HaloMinSize = 32
opt.uinfo.unbindflag = 1
opt.iBoundHalos = 1
opt.G = 43.0211349
opt.iSubSearch = 0
C.config_check(opt)
res = search_and_unbind(opt, pos, vel, mass, boxsize=box, device="cpu")
assert res.ngroups > 0, res.ngroups
assert res.pfof.shape == (len(pos),)
assert np.isfinite(res.W.numpy()).all()
assert set(res.timings) == {"fof", "unbind"}
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("OK", res.ngroups)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_kernels_import_without_nvcc():
    code = """
import sys
import velociraptor_stf_tpu_torch
from velociraptor_stf_tpu_torch import convert, kernels
from velociraptor_stf_tpu_torch.kernels import _build, fof_sweep, potential
from velociraptor_stf_tpu_torch.models import (halos, pipeline, properties,
                                               unbind)
from velociraptor_stf_tpu_torch.ops import cells, gravity, segments, so
from velociraptor_stf_tpu_torch import cli
assert _build._lib is None           # nothing compiled at import
assert set(kernels.LAUNCHES) == {"fof_detect", "fof_sweep3d",
                                 "fof_sweep6d", "potential"}
assert "jax" not in sys.modules
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_path_raises_without_toolkit():
    """The build step reports a missing nvcc instead of falling back."""
    code = """
from velociraptor_stf_tpu_torch.kernels import _build
try:
    _build._nvcc()
except RuntimeError as e:
    print("RAISED", e)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "RAISED" in proc.stdout


def test_port_writes_catalog_without_jax():
    """find_structures and the CLI on the CPU with jax never imported
    (the GPU machine has no jax and no h5py: binary catalogs)."""
    code = """
import sys, tempfile, os
import numpy as np
from velociraptor_stf_tpu.io import gadget
from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch import cli

n, box = 4096, 20.0
pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=6, seed=3)
d = tempfile.mkdtemp()
snap = os.path.join(d, "snap")
gadget.write_gadget(snap, pos, vel, np.arange(1, n + 1),
                    np.ones(n, np.int8), mass, boxsize=box, hubble=1.0)
cfg = os.path.join(d, "run.cfg")
with open(cfg, "w") as f:
    f.write(open("examples/sample_dmcosmological_run.cfg").read() +
            "\\nFoF_Field_search_type=4\\nSearch_for_substructure=0\\n"
            "Bound_halos=1\\nBinary_output=1\\nMinimum_halo_size=32\\n")
out = os.path.join(d, "cat")
assert cli.main(["-C", cfg, "-i", snap, "-o", out, "--device", "cpu"]) == 0
for ext in (".properties", ".catalog_groups", ".catalog_particles",
            ".hierarchy", ".profiles"):
    assert os.path.getsize(out + ext) > 0, ext
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
