"""Gadget-1/2 binary snapshot reader.

The port's copy of ``velociraptor_stf_tpu/io/gadget.py``, kept so that
the port imports nothing of the JAX package.

Replacement for the reference reader
(reference gadgetio.cxx:14 ``ReadGadget`` + gadgetitems.h): the
reference streams particles into per-rank MPI buffers; here the host reads
whole blocks with numpy (zero-copy from the record structure) and the device
transfer happens once.  Supports SnapFormat=1 and 2 (4-char block tags),
little/big endian autodetection, multi-file snapshots, LONGIDS, and the
per-type mass table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

NTYPES = 6


@dataclass
class GadgetHeader:
    npart: np.ndarray          # (6,) uint32 this file
    mass: np.ndarray           # (6,) float64 mass table
    time: float
    redshift: float
    flag_sfr: int
    flag_feedback: int
    npart_total: np.ndarray    # (6,) uint32
    flag_cooling: int
    num_files: int
    boxsize: float
    omega0: float
    omega_lambda: float
    hubble_param: float
    npart_total_hw: Optional[np.ndarray] = None  # high words (>2^32)

    @property
    def ntotal(self) -> int:
        tot = self.npart_total.astype(np.int64)
        if self.npart_total_hw is not None:
            tot = tot + (self.npart_total_hw.astype(np.int64) << 32)
        return int(tot.sum())


def _detect_endian(f) -> str:
    """First record marker is 256 (format 1) or 8 (format 2 'HEAD' tag)."""
    raw = f.read(4)
    f.seek(0)
    for endian in ("<", ">"):
        v = np.frombuffer(raw, dtype=endian + "u4")[0]
        if v in (256, 8):
            return endian
    raise ValueError("not a Gadget binary snapshot (bad record marker)")


def _read_record(f, endian) -> bytes:
    n1 = np.frombuffer(f.read(4), endian + "u4")[0]
    data = f.read(int(n1))
    n2 = np.frombuffer(f.read(4), endian + "u4")[0]
    if n1 != n2:
        raise ValueError(f"record marker mismatch {n1} != {n2}")
    return data


def _peek_format(f, endian) -> int:
    pos = f.tell()
    n1 = np.frombuffer(f.read(4), endian + "u4")[0]
    f.seek(pos)
    return 2 if n1 == 8 else 1


def _next_block(f, endian, fmt) -> Optional[str]:
    """Return the next block's 4-char tag (format 2) or None (format 1)."""
    if fmt == 2:
        tagrec = _read_record(f, endian)
        return tagrec[:4].decode("ascii", errors="replace").strip()
    return None


def read_header(fname: str) -> GadgetHeader:
    with open(fname, "rb") as f:
        endian = _detect_endian(f)
        fmt = _peek_format(f, endian)
        if fmt == 2:
            _next_block(f, endian, fmt)
        raw = _read_record(f, endian)
        return _parse_header(raw, endian)


def _parse_header(raw: bytes, endian) -> GadgetHeader:
    o = 0

    def take(dt, n):
        nonlocal o
        a = np.frombuffer(raw, dtype=endian + dt, count=n, offset=o)
        o += a.nbytes
        return a

    npart = take("u4", 6).copy()
    mass = take("f8", 6).copy()
    time_, redshift = take("f8", 1)[0], take("f8", 1)[0]
    flag_sfr, flag_feedback = int(take("i4", 1)[0]), int(take("i4", 1)[0])
    npart_total = take("u4", 6).copy()
    flag_cooling = int(take("i4", 1)[0])
    num_files = int(take("i4", 1)[0])
    boxsize = float(take("f8", 1)[0])
    omega0 = float(take("f8", 1)[0])
    omega_lambda = float(take("f8", 1)[0])
    hubble = float(take("f8", 1)[0])
    take("i4", 2)  # flag_stellarage, flag_metals
    npt_hw = take("u4", 6).copy()
    return GadgetHeader(npart=npart, mass=mass, time=float(time_),
                        redshift=float(redshift), flag_sfr=flag_sfr,
                        flag_feedback=flag_feedback,
                        npart_total=npart_total, flag_cooling=flag_cooling,
                        num_files=num_files, boxsize=boxsize, omega0=omega0,
                        omega_lambda=omega_lambda, hubble_param=hubble,
                        npart_total_hw=npt_hw)


def _snapshot_files(fname: str) -> List[str]:
    """Resolve single- vs multi-file snapshot names (name or name.0 ...)."""
    if os.path.exists(fname):
        hdr = read_header(fname)
        if hdr.num_files <= 1:
            return [fname]
    base = fname
    if os.path.exists(base + ".0"):
        hdr = read_header(base + ".0")
        return [f"{base}.{i}" for i in range(max(1, hdr.num_files))]
    if os.path.exists(fname):
        return [fname]
    raise FileNotFoundError(fname)


def read_gadget(fname: str, parttypes: Optional[List[int]] = None,
                pos_dtype=np.float32, nsnapread: int = 1):
    """Read a (multi-file) Gadget snapshot.

    Returns (header, pos (N,3), vel (N,3), pids (N,), ptype (N,), mass (N,)).
    Particle order: file order, types concatenated per file (gadget layout).
    Mirrors reference ReadGadget (gadgetio.cxx:14): unit conversions are the
    caller's job (pipeline applies Options conversions).

    ``nsnapread > 1`` reads that many snapshot files concurrently (the
    analog of the reference's read-rank split, ``MPIDistributeReadTasks``
    mpiroutines.cxx:527-782; threads instead of ranks — file I/O releases
    the GIL and frombuffer is zero-copy, so reads overlap).
    """
    files = _snapshot_files(fname)
    if nsnapread > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(nsnapread, len(files))) as ex:
            parts = list(ex.map(
                lambda fn: _read_gadget_file(fn, parttypes, pos_dtype),
                files))
    else:
        parts = [_read_gadget_file(fn, parttypes, pos_dtype)
                 for fn in files]
    hdr0 = parts[0][0]
    return (hdr0,
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
            np.concatenate([p[3] for p in parts]),
            np.concatenate([p[4] for p in parts]),
            np.concatenate([p[5] for p in parts]))


def _read_gadget_file(fn: str, parttypes, pos_dtype):
    """One snapshot file -> (hdr, pos, vel, pid, ptype, mass)."""
    with open(fn, "rb") as f:
            endian = _detect_endian(f)
            fmt = _peek_format(f, endian)
            if fmt == 2:
                _next_block(f, endian, fmt)
            hdr = _parse_header(_read_record(f, endian), endian)
            ntot = int(hdr.npart.sum())
            # POS
            if fmt == 2:
                _next_block(f, endian, fmt)
            raw = _read_record(f, endian)
            per = len(raw) // (ntot * 3)
            dt = "f4" if per == 4 else "f8"
            pos = np.frombuffer(raw, endian + dt).reshape(ntot, 3)
            # VEL
            if fmt == 2:
                _next_block(f, endian, fmt)
            raw = _read_record(f, endian)
            vel = np.frombuffer(raw, endian + dt).reshape(ntot, 3)
            # ID
            if fmt == 2:
                _next_block(f, endian, fmt)
            raw = _read_record(f, endian)
            idt = "u8" if len(raw) // ntot == 8 else "u4"
            pid = np.frombuffer(raw, endian + idt)
            # MASS block only for types with mass table zero and npart>0
            nwithmass = int(hdr.npart[(hdr.mass == 0) & (hdr.npart > 0)].sum())
            mass = np.empty(ntot, np.float64)
            fmass = None
            if nwithmass > 0:
                if fmt == 2:
                    _next_block(f, endian, fmt)
                raw = _read_record(f, endian)
                mdt = "f4" if len(raw) // nwithmass == 4 else "f8"
                fmass = np.frombuffer(raw, endian + mdt)
            # assemble per-type
            ptype = np.empty(ntot, np.int8)
            off, moff = 0, 0
            for t in range(NTYPES):
                n = int(hdr.npart[t])
                if n == 0:
                    continue
                ptype[off:off + n] = t
                if hdr.mass[t] > 0:
                    mass[off:off + n] = hdr.mass[t]
                else:
                    mass[off:off + n] = fmass[moff:moff + n]
                    moff += n
                off += n
            if parttypes is not None:
                selm = np.isin(ptype, parttypes)
                pos, vel, pid, ptype, mass = (a[selm] for a in
                                              (pos, vel, pid, ptype, mass))
    return (hdr, np.ascontiguousarray(pos, pos_dtype),
            np.ascontiguousarray(vel, pos_dtype), pid.copy(), ptype,
            mass.astype(pos_dtype))


def write_gadget(fname: str, pos, vel, pids, ptype, mass,
                 boxsize: float, time: float = 1.0, redshift: float = 0.0,
                 omega0: float = 0.3, omega_lambda: float = 0.7,
                 hubble: float = 0.7, num_files: int = 1):
    """Write a format-1 Gadget snapshot (test fixture writer).

    ``num_files > 1`` splits the particles evenly over ``fname.0`` ..
    ``fname.{num_files-1}`` with the multi-file header fields set (the
    layout the parallel ``-Z`` read path consumes)."""
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    pids = np.asarray(pids, np.uint32)
    ptype = np.asarray(ptype, np.int8)
    mass = np.asarray(mass, np.float32)
    order = np.argsort(ptype, kind="stable")
    pos, vel, pids, ptype, mass = (a[order] for a in
                                   (pos, vel, pids, ptype, mass))
    import struct

    n = len(pos)
    npart_tot = np.array([(ptype == t).sum() for t in range(NTYPES)],
                         np.uint32)

    def rec(b: bytes):
        return struct.pack("<I", len(b)) + b + struct.pack("<I", len(b))

    bounds = np.linspace(0, n, num_files + 1).astype(np.int64)
    for k in range(num_files):
        sl = slice(bounds[k], bounds[k + 1])
        pt = ptype[sl]
        npart = np.array([(pt == t).sum() for t in range(NTYPES)],
                         np.uint32)
        hdr = bytearray(256)
        struct.pack_into("<6I", hdr, 0, *npart.tolist())
        struct.pack_into("<6d", hdr, 24, *([0.0] * 6))
        struct.pack_into("<dd", hdr, 72, time, redshift)
        struct.pack_into("<ii", hdr, 88, 0, 0)
        struct.pack_into("<6I", hdr, 96, *npart_tot.tolist())
        struct.pack_into("<ii", hdr, 120, 0, num_files)
        struct.pack_into("<dddd", hdr, 128, boxsize, omega0,
                         omega_lambda, hubble)
        out = fname if num_files == 1 else f"{fname}.{k}"
        with open(out, "wb") as f:
            f.write(rec(bytes(hdr)))
            f.write(rec(pos[sl].astype("<f4").tobytes()))
            f.write(rec(vel[sl].astype("<f4").tobytes()))
            f.write(rec(pids[sl].astype("<u4").tobytes()))
            f.write(rec(mass[sl].astype("<f4").tobytes()))
