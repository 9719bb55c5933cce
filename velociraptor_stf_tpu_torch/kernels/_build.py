"""Build ``csrc/*.cu`` with nvcc into one shared library and load it.

The library has a plain C interface (no PyTorch headers), so nvcc builds it
in seconds; it is bound with ``ctypes``.  The output goes to
``build/velociraptor_stf_tpu_torch/`` at the root of the checkout, named by
a hash of the sources and flags, so an unchanged tree never rebuilds.

Flags: ``sm_90a`` (Hopper), and ``-fmad=false`` so that nvcc does not
contract ``a*b + c`` into an FMA -- link decisions at d = b must round like
the plain PyTorch versions.  No ``-use_fast_math`` (it flushes denormals to
zero and approximates division).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" /
              "velociraptor_stf_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# every entry point returns cudaGetLastError() after its launch
_SIGNATURES = {
    # (pos, ns, windows, b2, out, stream)
    "vr_fof_detect": (_P, _I, _P, _F, _P, _P),
    # (pos, labels, ns, windows, b2, out, stream)
    "vr_fof_sweep3d": (_P, _P, _I, _P, _F, _P, _P),
    # (pos, vel, rivs, grp, labels, ns, windows, inv_b2, out, stream)
    "vr_fof_sweep6d": (_P, _P, _P, _P, _P, _I, _P, _F, _P, _P),
    # (pos, mass, gid, ns, windows, eps2, out, stream)
    "vr_potential": (_P, _P, _P, _I, _P, _F, _P, _P),
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


def library_path() -> Tuple[Path, List[Path]]:
    """(library path keyed by the sources' hash, the sources)."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
