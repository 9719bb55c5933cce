"""Nchilada (ChaNGa) snapshot reader.

The port's copy of ``velociraptor_stf_tpu/io/nchilada.py``, kept so that
the port imports nothing of the JAX package.

Counterpart of the reference Nchilada input layer
(reference nchiladaio.cxx:320 ``ReadNchilada`` and
reference nchiladaitems.h): a snapshot is a directory with one
sub-directory per particle family (``gas/``, ``dark/``, ``star/``) and one
XDR (big-endian) field file per property (``pos``, ``vel``, ``mass``,
``iord``, ...).  Every field file starts with the header
(magic i4, time f8, iHighWord i4, nbodies i4, ndim i4, code i4 —
nchiladaitems.h:46-52) followed per dimension by (min, max) then the N
values — the exact record walk of the reference's ``readField3D``
(nchiladaitems.h:191-238), including its all-equal shortcut where a field
whose min == max stores no per-particle data.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = 1062053

# NCDataTypeCode (nchiladaitems.h:53-64) -> numpy big-endian dtypes
_CODE_DTYPE = {
    1: ">i1", 2: ">u1", 3: ">i2", 4: ">u2", 5: ">i4", 6: ">u4",
    7: ">i8", 8: ">u8", 9: ">f4", 10: ">f8",
}

# family dirs -> our particle type codes (nchiladaitems.h:31-39)
_FAMILIES = (("gas", 0), ("dark", 1), ("star", 4))


@dataclass
class NchiladaHeader:
    time: float = 0.0
    counts: Dict[str, int] = None


def read_field(fname: str) -> Tuple[float, np.ndarray]:
    """Read one XDR field file; returns (time, values) with values of shape
    (N,) or (N, ndim)."""
    with open(fname, "rb") as f:
        raw = f.read()
    magic = int(np.frombuffer(raw, ">i4", 1, 0)[0])
    if magic != MAGIC:
        raise ValueError(f"{fname}: bad nchilada magic {magic}")
    time = float(np.frombuffer(raw, ">f8", 1, 4)[0])
    nbodies = int(np.frombuffer(raw, ">i4", 1, 16)[0])
    ndim = int(np.frombuffer(raw, ">i4", 1, 20)[0])
    code = int(np.frombuffer(raw, ">i4", 1, 24)[0])
    dt = np.dtype(_CODE_DTYPE[code])
    off = 28
    cols = []
    for _ in range(max(ndim, 1)):
        mn = np.frombuffer(raw, dt, 1, off)[0]
        mx = np.frombuffer(raw, dt, 1, off + dt.itemsize)[0]
        off += 2 * dt.itemsize
        if mn == mx:
            cols.append(np.full(nbodies, mn))
        else:
            cols.append(np.frombuffer(raw, dt, nbodies, off).copy())
            off += nbodies * dt.itemsize
    if ndim <= 1:
        return time, np.asarray(cols[0])
    return time, np.stack(cols, axis=1)


def field_count(fname: str) -> int:
    """Particle count from a field header (reference ncGetCount,
    nchiladaio.cxx:236-260); 0 when unreadable."""
    try:
        with open(fname, "rb") as f:
            raw = f.read(28)
        if int(np.frombuffer(raw, ">i4", 1, 0)[0]) != MAGIC:
            return 0
        return int(np.frombuffer(raw, ">i4", 1, 16)[0])
    except Exception:
        return 0


def read_nchilada(path: str, parttypes: Optional[List[int]] = None):
    """Read an Nchilada snapshot directory.

    Returns (hdr, pos, vel, pids, ptype, mass) in file units, matching the
    other readers' convention (reference ReadNchilada,
    nchiladaio.cxx:320-464).
    """
    want = set(parttypes) if parttypes is not None else None
    poss, vels, idss, typs, masss = [], [], [], [], []
    time = 0.0
    counts: Dict[str, int] = {}
    for fam, tcode in _FAMILIES:
        if want is not None and tcode not in want:
            continue
        posf = os.path.join(path, fam, "pos")
        n = field_count(posf)
        counts[fam] = n
        if n == 0:
            continue
        time, p = read_field(posf)
        _, v = read_field(os.path.join(path, fam, "vel"))
        _, m = read_field(os.path.join(path, fam, "mass"))
        iordf = os.path.join(path, fam, "iord")
        if os.path.exists(iordf):
            _, pid = read_field(iordf)
            pid = np.asarray(pid, np.int64)
        else:
            pid = np.arange(1, n + 1, dtype=np.int64) + \
                (tcode << 40)
        poss.append(np.asarray(p, np.float64))
        vels.append(np.asarray(v, np.float64))
        masss.append(np.asarray(m, np.float64))
        idss.append(pid)
        typs.append(np.full(n, tcode, np.int8))
    if not poss:
        raise ValueError(f"no particles found under {path}")
    hdr = NchiladaHeader(time=time, counts=counts)
    return (hdr, np.concatenate(poss), np.concatenate(vels),
            np.concatenate(idss), np.concatenate(typs),
            np.concatenate(masss))
