"""The PyTorch port imports and runs without JAX, without the JAX package
and without nvcc.

A subprocess is needed: tests/conftest.py imports jax into this process.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# after a run: neither jax nor any module of the JAX package was imported
NO_JAX_PACKAGE = """
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "velociraptor_stf_tpu"
                or m.startswith("velociraptor_stf_tpu."))
assert not leaked, leaked
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # no CUDA toolkit reachable: importing must not need one
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(
        os.pathsep) if "cuda" not in p.lower())
    env["CUDA_HOME"] = str(REPO / "no-such-cuda")
    env["OMP_NUM_THREADS"] = "1"      # as torch_threads.py, for the child
    return subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_runs_slice_without_jax():
    code = """
import sys
import numpy as np
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch.models.pipeline import search_and_unbind
from velociraptor_stf_tpu_torch.utils import config as C

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
""" + NO_JAX_PACKAGE + """
print("OK", res.ngroups)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_runs_hydro_path_without_jax():
    """find_structures on several particle types with a baryon search:
    the pair pipeline, the association, the combined unbind and the
    per-type properties, with jax never imported."""
    code = """
import sys
import numpy as np
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch.models.pipeline import find_structures
from velociraptor_stf_tpu_torch.utils import config as C

n, box = 4096, 20.0
pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=6, seed=3)
ptype = np.where(np.arange(len(pos)) % 6 == 5, 0, 1).astype(np.int8)
ptype[5::12] = 4
opt = C.Options()
opt.ellphys = 0.2
opt.ellxscale = box / n ** (1 / 3)
opt.fofbgtype = C.FOF6D
opt.MinSize = 20
opt.uinfo.unbindflag = 1
opt.iBoundHalos = 1
opt.G = 43.0211349
opt.iSubSearch = 0
opt.iBaryonSearch = 1
opt.partsearchtype = C.PSTALL
C.config_check(opt)
res = find_structures(opt, pos, vel, mass, boxsize=box, ptype=ptype,
                      extras={"u": np.ones(len(pos), np.float32)},
                      device="cpu")
assert res.ngroups > 0, res.ngroups
assert (res.pfof[ptype != 1] > 0).any()
assert res.props["n_gas"][1:].sum() > 0 and "Temp_mean_gas" in res.props
assert {"fof", "unbind", "baryons", "properties"} <= set(res.timings)
""" + NO_JAX_PACKAGE + """
print("OK", res.ngroups)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_import_scan_covers_hydro_modules():
    """The ast scan below globs the package: the pair pipeline and the
    baryon association are among the files it reads."""
    files = {f.relative_to(REPO).as_posix()
             for f in (REPO / "velociraptor_stf_tpu_torch").rglob("*.py")}
    assert {"velociraptor_stf_tpu_torch/ops/fof.py",
            "velociraptor_stf_tpu_torch/models/baryons.py"} <= files


def test_import_scan_covers_substructure_modules():
    """The ast scan reads the substructure recursion's modules too."""
    files = {f.relative_to(REPO).as_posix()
             for f in (REPO / "velociraptor_stf_tpu_torch").rglob("*.py")}
    assert {f"velociraptor_stf_tpu_torch/{m}.py" for m in (
        "ops/kdgrid", "models/localfield", "models/bgfield",
        "models/substructure", "models/haloprops", "io/cache")} <= files


def test_import_scan_covers_mesh_modules():
    """The ast scan reads every module of the multi-device mode."""
    files = {f.relative_to(REPO).as_posix()
             for f in (REPO / "velociraptor_stf_tpu_torch").rglob("*.py")}
    assert {f"velociraptor_stf_tpu_torch/{m}.py" for m in (
        "parallel/__init__", "parallel/mesh", "parallel/collectives",
        "parallel/grouppack", "parallel/distributed_fof",
        "parallel/distributed_unbind", "parallel/distributed_props",
        "parallel/distributed_so", "parallel/distributed_localfield",
        "parallel/distributed_substructure", "parallel/distributed_baryons",
        "utils/transfer")} <= files


def test_port_runs_mesh_without_jax():
    """Every module of parallel/ imported, and find_structures over a
    mesh of four CPU shards (recursion and baryon search on) equal to the
    run without a mesh, with jax never imported."""
    code = """
import importlib, pkgutil, sys
import numpy as np
import velociraptor_stf_tpu_torch.parallel as par
for m in pkgutil.iter_modules(par.__path__):
    importlib.import_module("velociraptor_stf_tpu_torch.parallel." + m.name)
import velociraptor_stf_tpu_torch.utils.transfer
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch.models.pipeline import find_structures
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.utils import config as C
box, n = 30.0, 1 << 13
pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=8, seed=4)
ptype = np.where(np.arange(n) % 6 == 5, C.GASTYPE, C.DARKTYPE)
opt = C.Options()
opt.ellphys, opt.ellxscale, opt.fofbgtype = 0.2, box / n ** (1 / 3), C.FOF6D
opt.MinSize, opt.HaloMinSize, opt.G = 20, 32, 43.0211349
opt.uinfo.unbindflag, opt.iBoundHalos, opt.iSubSearch = 1, 1, 1
opt.iBaryonSearch, opt.partsearchtype = 1, C.PSTALL
C.config_check(opt)
one = find_structures(opt, pos, vel, mass, boxsize=box, ptype=ptype,
                      device="cpu")
four = find_structures(opt, pos, vel, mass, boxsize=box, ptype=ptype,
                       mesh=make_mesh(4, "cpu"))
assert four.ngroups == one.ngroups > 0
assert (four.pfof == one.pfof).all()
""" + NO_JAX_PACKAGE + """
print("OK", one.ngroups)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_runs_substructure_without_jax():
    """find_structures with iSubSearch = 1 and the merger-core search on
    planted subhalos, with jax never imported."""
    code = """
import sys
import numpy as np
from velociraptor_stf_tpu_torch.io.synthetic import G_KMS, planted_subhalos
from velociraptor_stf_tpu_torch.models.pipeline import find_structures
from velociraptor_stf_tpu_torch.utils import config as C

pos, vel, mass, host = planted_subhalos(2, seed=3, offset=4.0)
opt = C.Options()
opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
opt.fofbgtype = C.FOF3D
opt.MinSize = opt.HaloMinSize = 20
opt.iSubSearch, opt.iiterflag, opt.iHaloCoreSearch = 1, 1, 2
opt.uinfo.unbindflag, opt.iBoundHalos, opt.G = 1, 2, G_KMS
C.config_check(opt)
res = find_structures(opt, pos, vel, mass, boxsize=12.0, device="cpu")
assert res.ngroups > 2 and (res.parent > 0).any(), res.ngroups
assert {"fof", "unbind", "substructure", "subsub_outliers"} <= \
    set(res.timings)
""" + NO_JAX_PACKAGE + """
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
from velociraptor_stf_tpu_torch.models import (baryons, bgfield, halos,
                                               haloprops, localfield,
                                               pipeline, properties,
                                               substructure, unbind)
from velociraptor_stf_tpu_torch.ops import (cells, fof, gravity, kdgrid,
                                            segments, so)
from velociraptor_stf_tpu_torch.io import cache
from velociraptor_stf_tpu_torch import api, cli, particles
assert _build._lib is None           # nothing compiled at import
assert set(kernels.LAUNCHES) == {"fof_detect", "fof_sweep3d",
                                 "fof_sweep6d", "potential",
                                 "segment_moments"}
""" + NO_JAX_PACKAGE + """
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
from velociraptor_stf_tpu_torch import cli
from velociraptor_stf_tpu_torch.io import gadget
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock

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
""" + NO_JAX_PACKAGE + """
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_library_api_runs_without_jax():
    """``api.VelociraptorSession.invoke`` on a ``ParticleSet`` of tensors
    on the CPU with jax never imported, catalog written."""
    code = """
import sys, tempfile, os
import numpy as np
from velociraptor_stf_tpu_torch import api
from velociraptor_stf_tpu_torch.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu_torch.particles import ParticleSet

n, box = 4096, 20.0
pos, vel, mass = make_cosmo_mock(n, boxsize=box, nhalos=6, seed=3)
session = api.VelociraptorSession(config_text=(
    open("examples/sample_dmcosmological_run.cfg").read() +
    "\\nFoF_Field_search_type=4\\nSearch_for_substructure=0\\n"
    "Bound_halos=1\\nBinary_output=1\\nMinimum_halo_size=32\\n"))
out = os.path.join(tempfile.mkdtemp(), "cat")
ps = ParticleSet.from_numpy(pos, vel, mass, pid=np.arange(1, len(pos) + 1))
res = session.invoke(ps, sim=api.SimInfo(
    period=box, interparticlespacing=box / n ** (1 / 3)), outname=out,
    write_output=True, device="cpu")
assert res["ngroups"] > 0 and res["group_id"].shape == (len(pos),)
for ext in (".properties", ".catalog_groups", ".catalog_particles"):
    assert os.path.getsize(out + ext) > 0, ext
""" + NO_JAX_PACKAGE + """
print("OK", res["ngroups"])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


def _imports(path: Path, root: Path = REPO):
    """(line, module) of every import statement in the file at ``path``,
    relative imports resolved against the file's package under ``root``;
    ``from a import b`` gives both ``a`` and ``a.b``."""
    package = list(path.relative_to(root).parts[:-1])
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            mod = base + ([node.module] if node.module else [])
            if mod:
                yield node.lineno, ".".join(mod)
            for alias in node.names:
                yield node.lineno, ".".join(mod + [alias.name])


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "velociraptor_stf_tpu")


@pytest.mark.parametrize("tree", ["velociraptor_stf_tpu_torch",
                                  "chip_smoke.py"])
def test_port_imports_nothing_of_jax_package(tree):
    """An ast scan of every module of the port and of chip_smoke.py: no
    import of jax or of the JAX package, at any depth of the code."""
    top = REPO / tree
    files = sorted(top.rglob("*.py")) if top.is_dir() else [top]
    assert files
    bad = [f"{f.relative_to(REPO)}:{line}: {mod}" for f in files
           for line, mod in _imports(f) if _forbidden(mod)]
    assert not bad, bad


def test_import_scan_catches_jax_imports(tmp_path):
    """The scan sees absolute, dotted, nested and relative imports that
    climb out of the port."""
    src = tmp_path / "velociraptor_stf_tpu_torch" / "mod.py"
    src.parent.mkdir()
    src.write_text("import os\n"
                   "from . import kernels\n"
                   "from .. import velociraptor_stf_tpu\n"
                   "def f():\n"
                   "    import jax.numpy as jnp\n"
                   "    from velociraptor_stf_tpu.utils import config\n"
                   "    import velociraptor_stf_tpu.io.gadget\n")
    found = [mod for _, mod in _imports(src, tmp_path) if _forbidden(mod)]
    assert found == ["velociraptor_stf_tpu", "jax.numpy",
                     "velociraptor_stf_tpu.utils",
                     "velociraptor_stf_tpu.utils.config",
                     "velociraptor_stf_tpu.io.gadget"]
