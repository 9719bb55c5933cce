"""TIPSY binary snapshot reader.

The port's copy of ``velociraptor_stf_tpu/io/tipsy.py``, kept so that
the port imports nothing of the JAX package.

Reference: reference tipsyio.cxx:13 ``ReadTipsy`` +
tipsy_structs.h.  Standard TIPSY layout: header (time, nbodies, ndim,
nsph, ndark, nstar), then gas / dark / star particle records.  Endianness
auto-detected from the ndim field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TipsyHeader:
    time: float
    nbodies: int
    ndim: int
    nsph: int
    ndark: int
    nstar: int


def _header_dtype(endian):
    return np.dtype([("time", endian + "f8"), ("nbodies", endian + "i4"),
                     ("ndim", endian + "i4"), ("nsph", endian + "i4"),
                     ("ndark", endian + "i4"), ("nstar", endian + "i4"),
                     ("pad", endian + "i4")])


def _gas_dtype(endian):
    return np.dtype([("mass", endian + "f4"), ("pos", endian + "f4", 3),
                     ("vel", endian + "f4", 3), ("rho", endian + "f4"),
                     ("temp", endian + "f4"), ("hsmooth", endian + "f4"),
                     ("metals", endian + "f4"), ("phi", endian + "f4")])


def _dark_dtype(endian):
    return np.dtype([("mass", endian + "f4"), ("pos", endian + "f4", 3),
                     ("vel", endian + "f4", 3), ("eps", endian + "f4"),
                     ("phi", endian + "f4")])


def _star_dtype(endian):
    return np.dtype([("mass", endian + "f4"), ("pos", endian + "f4", 3),
                     ("vel", endian + "f4", 3), ("metals", endian + "f4"),
                     ("tform", endian + "f4"), ("eps", endian + "f4"),
                     ("phi", endian + "f4")])


def read_tipsy(fname: str, pos_dtype=np.float32):
    """Returns (header, pos, vel, pids, ptype, mass); gadget type codes
    (gas=0, dark=1, star=4); pids sequential (tipsy has none)."""
    with open(fname, "rb") as f:
        raw = f.read()
    for endian in ("<", ">"):
        hdr = np.frombuffer(raw, _header_dtype(endian), count=1)[0]
        if hdr["ndim"] in (1, 2, 3) and hdr["nbodies"] >= 0 and \
                hdr["nbodies"] == hdr["nsph"] + hdr["ndark"] + hdr["nstar"]:
            break
    else:
        raise ValueError("not a TIPSY file")
    header = TipsyHeader(float(hdr["time"]), int(hdr["nbodies"]),
                         int(hdr["ndim"]), int(hdr["nsph"]),
                         int(hdr["ndark"]), int(hdr["nstar"]))
    o = _header_dtype(endian).itemsize
    gas = np.frombuffer(raw, _gas_dtype(endian), count=header.nsph, offset=o)
    o += gas.nbytes
    dark = np.frombuffer(raw, _dark_dtype(endian), count=header.ndark,
                         offset=o)
    o += dark.nbytes
    star = np.frombuffer(raw, _star_dtype(endian), count=header.nstar,
                         offset=o)
    pos = np.concatenate([gas["pos"], dark["pos"],
                          star["pos"]]).astype(pos_dtype)
    vel = np.concatenate([gas["vel"], dark["vel"],
                          star["vel"]]).astype(pos_dtype)
    mass = np.concatenate([gas["mass"], dark["mass"],
                           star["mass"]]).astype(pos_dtype)
    ptype = np.concatenate([np.zeros(header.nsph, np.int8),
                            np.ones(header.ndark, np.int8),
                            np.full(header.nstar, 4, np.int8)])
    pids = np.arange(header.nbodies, dtype=np.int64)
    return header, pos, vel, pids, ptype, mass


def write_tipsy(fname: str, pos, vel, mass, ptype, time: float = 1.0):
    """Test-fixture writer (little-endian)."""
    endian = "<"
    gas_sel, dark_sel, star_sel = (ptype == 0), (ptype == 1), (ptype == 4)
    hdr = np.zeros(1, _header_dtype(endian))
    hdr["time"], hdr["ndim"] = time, 3
    hdr["nsph"], hdr["ndark"], hdr["nstar"] = \
        gas_sel.sum(), dark_sel.sum(), star_sel.sum()
    hdr["nbodies"] = int(hdr["nsph"] + hdr["ndark"] + hdr["nstar"])
    with open(fname, "wb") as f:
        f.write(hdr.tobytes())
        g = np.zeros(gas_sel.sum(), _gas_dtype(endian))
        g["mass"], g["pos"], g["vel"] = mass[gas_sel], pos[gas_sel], vel[gas_sel]
        f.write(g.tobytes())
        d = np.zeros(dark_sel.sum(), _dark_dtype(endian))
        d["mass"], d["pos"], d["vel"] = mass[dark_sel], pos[dark_sel], vel[dark_sel]
        f.write(d.tobytes())
        s = np.zeros(star_sel.sum(), _star_dtype(endian))
        s["mass"], s["pos"], s["vel"] = mass[star_sel], pos[star_sel], vel[star_sel]
        f.write(s.tobytes())
