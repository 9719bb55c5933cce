"""Build ``csrc/*.cu`` with nvcc into one shared library and load it.

The library has a plain C interface (no PyTorch headers), so nvcc builds it
in seconds; it is bound with ``ctypes``.  One nvcc per source, all started
together, then one link.  The output goes to
``build/velociraptor_stf_tpu_torch/`` at the root of the checkout, named by
a hash of the sources and flags, so an unchanged tree never rebuilds.  The
potential kernel's launch geometry comes from ``potential.py`` as ``-D``
defines (``defines``).

Flags: ``sm_90a`` (Hopper), and ``-fmad=false`` so that nvcc does not
contract ``a*b + c`` into an FMA -- link decisions at d = b must round like
the plain PyTorch versions.  The potential kernel asks for its FMAs
explicitly (``__fmaf_rn``), which the flag leaves alone.  No
``-use_fast_math`` (it flushes denormals to zero and approximates
division).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" /
              "velociraptor_stf_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every launching entry point returns cudaGetLastError() after its launch
_SIGNATURES = {
    # (packed (x, y, z, z cell), z-column, column starts, ns, nx, ny, b2,
    #  out, stream)
    "vr_fof_detect": (_P, _P, _P, _I, _I, _I, _F, _P, _P),
    # (packed (x, y, z, .), labels, cell, cell windows, ns, b2, out, stream)
    "vr_fof_sweep3d": (_P, _P, _P, _P, _I, _F, _P, _P),
    # (packed (x, y, z, grp), packed (vx, vy, vz, rivs), labels, cell,
    #  cell windows, ns, inv_b2, out, stream)
    "vr_fof_sweep6d": (_P, _P, _P, _P, _P, _I, _F, _P, _P),
    # (packed (x, y, z, m), row windows, ns, items, nitems, first, eps2,
    #  scratch, out, stream)
    "vr_potential": (_P, _P, _I, _P, _I, _P, _F, _P, _P, _P),
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def defines() -> Tuple[str, ...]:
    """``-D`` flags of the potential kernel's launch geometry, whose one
    source is ``potential.py``."""
    from . import potential

    return (f"-DVR_POT_THREADS={potential.THREADS}",
            f"-DVR_POT_ROWS_PER_THREAD={potential.ROWS_PER_THREAD}",
            f"-DVR_POT_TILE={potential.TILE}")


def library_path() -> Tuple[Path, List[Path]]:
    """(library path keyed by the sources' and flags' hash, the sources)."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS + defines():
        digest.update(flag.encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"libvr_kernels_{digest.hexdigest()[:16]}.so", sources


def build() -> Path:
    """Compile the library unless a build of the same sources exists; the
    compiler's report (registers, spills per kernel) goes beside it as
    ``.log``."""
    out, sources = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, *defines(), "-c", "-o", str(obj),
                 str(src)] for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = Path(tmpdir) / out.name
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        for cmd, proc, text in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:"
                                   f"\n{' '.join(cmd)}\n{text}")
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code "
                               f"{done.returncode}:\n{' '.join(link)}\n"
                               f"{done.stdout}{done.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
