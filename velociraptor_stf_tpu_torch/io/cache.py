"""Velocity-density checkpoint cache.

The port's copy of ``velociraptor_stf_tpu/io/cache.py``, kept so that the
port imports nothing of the JAX package.

The reference's only checkpoint/resume facility: the local velocity density
field can be written after computation and re-read on re-runs to skip the
most expensive phase (reference io.cxx:178-251
``ReadLocalVelocityDensity``/``WriteLocalVelocityDensity``; enabled by the
``Output_den`` config key, main.cxx:271-275).  Stored as .npz keyed by a
content hash of the particle ids so a stale cache is never applied.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _fingerprint(pids: np.ndarray) -> np.ndarray:
    pids = np.asarray(pids)
    return np.array([len(pids),
                     int(np.bitwise_xor.reduce(pids.astype(np.int64)))
                     if len(pids) else 0])


def write_local_velocity_density(fname: str, density: np.ndarray,
                                 pids: np.ndarray) -> None:
    np.savez_compressed(fname, density=np.asarray(density),
                        fingerprint=_fingerprint(pids))


def write_density_cache(fname: str, dens: dict, pfof: np.ndarray) -> None:
    """Write the per-structure velocity-density dict (pipeline checkpoint,
    keys 'l<level>g<gid>'), fingerprinted by the group labels so a cache
    from a different snapshot/search is never replayed."""
    path = fname if fname.endswith(".npz") else fname + ".npz"
    np.savez_compressed(path, __fingerprint=_fingerprint(pfof), **dens)


def read_density_cache(fname: str, pfof: np.ndarray) -> Optional[dict]:
    """Returns {'l<level>g<gid>': density} or None (missing/mismatched)."""
    path = fname if fname.endswith(".npz") else fname + ".npz"
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if not np.array_equal(z["__fingerprint"], _fingerprint(pfof)):
                return None
            return {k: z[k] for k in z.files if k != "__fingerprint"}
    except Exception:
        return None


def read_local_velocity_density(fname: str,
                                pids: np.ndarray) -> Optional[np.ndarray]:
    """Returns the cached densities or None (missing / mismatched)."""
    path = fname if fname.endswith(".npz") else fname + ".npz"
    if not os.path.exists(path):
        if os.path.exists(fname):
            path = fname
        else:
            return None
    try:
        with np.load(path) as z:
            if np.array_equal(z["fingerprint"], _fingerprint(pids)):
                return z["density"]
    except Exception:
        return None
    return None
