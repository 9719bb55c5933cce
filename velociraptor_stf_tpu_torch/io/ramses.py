"""RAMSES snapshot reader (particles + AMR gas cells -> particles).

The port's copy of ``velociraptor_stf_tpu/io/ramses.py``, kept so that
the port imports nothing of the JAX package.

Counterpart of the reference RAMSES input layer
(reference ramsesio.cxx): ``ReadRamses``:430 with the Fortran
unformatted record walk of ``RAMSES_fortran_read/skip`` (:26-79), the
info_XXXXX.txt cosmology parse (:548-570), particle classification by birth
epoch (age==0 -> DM, else star; ghost particles rejected by mass mismatch,
:387-400 / 1380-1420) and the AMR leaf-cell -> gas-particle conversion
(:1095-1250): every cell with no son (or at the maximum level) becomes one
gas particle with mass rho*dx^3, velocity from the hydro variables and
internal energy u = P/rho/(gamma-1).

The record sequence mirrors the reference exactly (including its
one-grid-list-per-file assumption) so snapshots the reference can read are
read identically here.  Units returned: positions in comoving kpc (and
``boxsize`` to match), velocities in km/s, masses in Msun — the reference's
lscale/mscale/velocity conversions (:607-620).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_KPC_CM = 3.086e21
_MSUN_G = 1.988e33


class _FortranFile:
    """Minimal sequential Fortran unformatted record reader
    (4-byte record markers, little endian)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")

    def close(self):
        self.f.close()

    def read(self, dtype=None):
        hdr = self.f.read(4)
        if len(hdr) < 4:
            return None
        n = int(np.frombuffer(hdr, "<i4")[0])
        data = self.f.read(n)
        self.f.read(4)
        if dtype is None:
            return data
        return np.frombuffer(data, dtype)

    def skip(self, k: int = 1):
        for _ in range(k):
            hdr = self.f.read(4)
            if len(hdr) < 4:
                return
            n = int(np.frombuffer(hdr, "<i4")[0])
            self.f.seek(n + 4, os.SEEK_CUR)

    def read_int(self) -> int:
        return int(self.read("<i4")[0])

    def read_float(self) -> float:
        return float(self.read("<f8")[0])


@dataclass
class RamsesHeader:
    ncpu: int = 1
    ndim: int = 3
    levelmin: int = 1
    levelmax: int = 1
    boxlen: float = 1.0
    time: float = 0.0
    aexp: float = 1.0
    h0: float = 100.0
    omega_m: float = 0.3
    omega_l: float = 0.7
    omega_k: float = 0.0
    omega_b: float = 0.0
    unit_l: float = _KPC_CM     # cm
    unit_d: float = 1.0         # g/cm^3
    unit_t: float = 1.0         # s
    ordering: str = "hilbert"
    boxsize: float = 1.0        # comoving kpc (lscale applied)
    gamma: float = 5.0 / 3.0
    # unit scales (reference :607-620)
    lscale: float = 1.0         # code position [0,boxlen] -> comoving kpc
    vscale: float = 1.0         # code velocity -> km/s
    mscale: float = 1.0         # code mass -> Msun
    rhoscale: float = 1.0       # code density -> Msun/kpc^3


def read_info(path: str, snapname: str) -> RamsesHeader:
    """Parse info_<snap>.txt (reference ramsesio.cxx:548-570)."""
    hdr = RamsesHeader()
    fname = os.path.join(path, f"info_{snapname}.txt")
    keys = {
        "ncpu": ("ncpu", int), "ndim": ("ndim", int),
        "levelmin": ("levelmin", int), "levelmax": ("levelmax", int),
        "boxlen": ("boxlen", float), "time": ("time", float),
        "aexp": ("aexp", float), "H0": ("h0", float),
        "omega_m": ("omega_m", float), "omega_l": ("omega_l", float),
        "omega_k": ("omega_k", float), "omega_b": ("omega_b", float),
        "unit_l": ("unit_l", float), "unit_d": ("unit_d", float),
        "unit_t": ("unit_t", float),
    }
    with open(fname) as f:
        for line in f:
            m = re.match(r"\s*(\w+)\s*=\s*(\S+)", line)
            if m and m.group(1) in keys:
                attr, cast = keys[m.group(1)]
                setattr(hdr, attr, cast(m.group(2)))
            elif line.strip().startswith("ordering type"):
                hdr.ordering = line.split("=")[-1].strip()
    hdr.lscale = hdr.unit_l / _KPC_CM                       # cm -> kpc
    hdr.vscale = hdr.unit_l / hdr.unit_t * 1e-5             # -> km/s
    hdr.mscale = hdr.unit_d * hdr.unit_l ** 3 / _MSUN_G     # -> Msun
    hdr.rhoscale = hdr.mscale / hdr.lscale ** 3
    hdr.boxsize = hdr.boxlen * hdr.lscale
    return hdr


def _files(path: str, prefix: str, snapname: str) -> List[str]:
    one = os.path.join(path, f"{prefix}_{snapname}.out")
    if os.path.exists(one):
        return [one]
    out, i = [], 1
    while True:
        fn = os.path.join(path, f"{prefix}_{snapname}.out{i:05d}")
        if not os.path.exists(fn):
            break
        out.append(fn)
        i += 1
    return out


def read_part_files(path: str, snapname: str, hdr: RamsesHeader):
    """Read part_<snap>.out* (reference ramsesio.cxx:667-830).

    Record layout per file: ncpu, ndim, npart, localseed, nstar_tot,
    mstar_tot, mstar_lost, nsink, then x/y/z, vx/vy/vz, mass, id, level,
    [birth epoch, metallicity].  Classification: age==0 -> DM, else star;
    ghosts (age==0 with mass far from the DM particle mass) are dropped
    (reference :387-400).
    """
    poss, vels, masss, idss, ages, mets = [], [], [], [], [], []
    for fn in _files(path, "part", snapname):
        F = _FortranFile(fn)
        F.skip(2)                     # ncpu, ndim
        npart = F.read_int()
        F.skip(5)                     # localseed nstar mstar mstarlost nsink
        x = [F.read("<f8") for _ in range(hdr.ndim)]
        v = [F.read("<f8") for _ in range(hdr.ndim)]
        m = F.read("<f8")
        raw = F.read()
        ids = np.frombuffer(raw, "<i8" if len(raw) == 8 * npart else "<i4")
        F.skip(1)                     # level
        age = F.read("<f8")
        met = F.read("<f8")
        F.close()
        poss.append(np.stack(x, axis=1))
        vels.append(np.stack(v, axis=1))
        masss.append(np.asarray(m))
        idss.append(np.asarray(ids, np.int64))
        ages.append(np.asarray(age) if age is not None
                    else np.zeros(npart))
        mets.append(np.asarray(met) if met is not None
                    else np.zeros(npart))
    if not poss:
        return (np.zeros((0, 3)),) * 2 + (np.zeros(0),) * 2 + \
            (np.zeros(0, np.int64),) + (np.zeros(0),)
    pos = np.concatenate(poss)
    vel = np.concatenate(vels)
    mass = np.concatenate(masss)
    pid = np.concatenate(idss)
    age = np.concatenate(ages)
    met = np.concatenate(mets)
    # ghost rejection: DM particle mass = modal mass of age==0 particles
    isdm0 = age == 0.0
    if isdm0.any():
        dmp = np.median(mass[isdm0])
        ghost = isdm0 & (np.abs(mass - dmp) / max(dmp, 1e-300) > 1e-5)
    else:
        ghost = np.zeros(len(mass), bool)
    keep = ~ghost
    return (pos[keep], vel[keep], mass[keep], age[keep], pid[keep],
            met[keep])


def read_amr_gas(path: str, snapname: str, hdr: RamsesHeader,
                 jitter_seed: Optional[int] = None):
    """AMR leaf cells -> gas particles (reference ramsesio.cxx:1028-1260).

    Returns (pos, vel, mass, u, rho, zmet) in code units ([0,1] positions).
    ``jitter_seed`` reproduces the reference's uniform within-cell jitter;
    None places particles at cell centres (deterministic).
    """
    rng = np.random.default_rng(jitter_seed) \
        if jitter_seed is not None else None
    poss, vels, masss, us, rhos, zs = [], [], [], [], [], []
    amr_files = _files(path, "amr", snapname)
    hyd_files = _files(path, "hydro", snapname)
    for afn, hfn in zip(amr_files, hyd_files):
        A = _FortranFile(afn)
        H = _FortranFile(hfn)
        A.skip(1)                     # ncpu
        ndim = A.read_int()
        nxyz = A.read("<i4")          # nx, ny, nz in one record
        nlevelmax = A.read_int()
        A.skip(1)                     # ngridmax
        nboundary = A.read_int()
        A.skip(1)                     # ngrid_current
        A.skip(14)
        twotondim = 2 ** ndim
        # hydro header (reference :1063-1068)
        H.skip(1)                     # ncpu
        nvarh = H.read_int()
        H.skip(3)                     # ndim, nlevelmax, nboundary
        gamma = H.read_float()
        # grid counts (reference :1072-1092)
        ngridlevel = np.asarray(A.read("<i4"))[:nlevelmax]
        ngridfile = np.zeros((1 + nboundary, nlevelmax), np.int64)
        ngridfile[0] = ngridlevel
        A.skip(1)
        if nboundary > 0:
            A.skip(2)
            gb = np.asarray(A.read("<i4"))
            ngridfile[1:] = gb.reshape(nboundary, nlevelmax)
        A.skip(2)
        A.skip(5 if hdr.ordering == "bisection" else 4)

        for k in range(nboundary + 1):
            for j in range(nlevelmax):
                chunk = int(ngridfile[k, j])
                if chunk > 0:
                    A.skip(3)         # grid index, next, prev
                    xg = np.stack([np.asarray(A.read("<f8"))
                                   for _ in range(ndim)], axis=1)
                    A.skip(1 + 2 * ndim)   # father + neighbours
                    son = np.stack([np.asarray(A.read("<i4"))
                                    for _ in range(twotondim)], axis=0)
                    A.skip(2 * twotondim)  # cpu map + refinement map
                H.skip(1)
                if chunk <= 0:
                    continue
                hyd = np.zeros((twotondim, nvarh, chunk))
                for ind in range(twotondim):
                    for ivar in range(nvarh):
                        hyd[ind, ivar] = np.asarray(H.read("<f8"))
                dx = 0.5 ** j
                for ind in range(twotondim):
                    leaf = (son[ind] == 0) | (j == nlevelmax - 1)
                    if not leaf.any():
                        continue
                    iz = ind // 4
                    iy = (ind - 4 * iz) // 2
                    ix = ind - 2 * iy - 4 * iz
                    off = (np.array([ix, iy, iz]) - 0.5) * dx
                    ctr = xg[leaf] + off[None, :]
                    if rng is not None:
                        ctr = ctr + (rng.random(ctr.shape) - 0.5) * dx
                    rho = hyd[ind, 0, leaf]
                    poss.append(ctr)
                    vels.append(np.stack([hyd[ind, 1, leaf],
                                          hyd[ind, 2, leaf],
                                          hyd[ind, 3, leaf]], axis=1))
                    masss.append(rho * dx ** 3)
                    if nvarh > 4:
                        us.append(hyd[ind, 4, leaf] /
                                  np.maximum(rho, 1e-300) / (gamma - 1.0))
                    else:
                        us.append(np.zeros(int(leaf.sum())))
                    rhos.append(rho)
                    zs.append(hyd[ind, 5, leaf] if nvarh > 5
                              else np.zeros(int(leaf.sum())))
        A.close()
        H.close()
    if not poss:
        z = np.zeros(0)
        return np.zeros((0, 3)), np.zeros((0, 3)), z, z, z, z
    return (np.concatenate(poss), np.concatenate(vels),
            np.concatenate(masss), np.concatenate(us),
            np.concatenate(rhos), np.concatenate(zs))


def read_ramses(path: str, snapname: str,
                parttypes: Optional[List[int]] = None,
                jitter_seed: Optional[int] = None):
    """Full RAMSES snapshot (reference ReadRamses, ramsesio.cxx:430).

    Returns (hdr, pos, vel, pids, ptype, mass, extras) matching the other
    readers' convention: positions/boxsize in comoving kpc, velocities in
    km/s, masses in Msun; ptype 0=gas 1=DM 4=star; extras = per-particle
    {u, sfr, zmet, tage} (zeros where not applicable).
    """
    hdr = read_info(path, snapname)
    want = set(parttypes) if parttypes is not None else None

    parts = []
    ppos, pvel, pmass, page, ppid, pmet = read_part_files(path, snapname,
                                                          hdr)
    isstar = page != 0.0
    if want is None or 1 in want:
        sel = ~isstar
        parts.append((ppos[sel], pvel[sel], pmass[sel], ppid[sel],
                      np.full(int(sel.sum()), 1, np.int8),
                      np.zeros(int(sel.sum())), pmet[sel],
                      np.zeros(int(sel.sum()))))
    if want is None or 4 in want:
        sel = isstar
        parts.append((ppos[sel], pvel[sel], pmass[sel], ppid[sel],
                      np.full(int(sel.sum()), 4, np.int8),
                      np.zeros(int(sel.sum())), pmet[sel], page[sel]))
    if (want is None or 0 in want) and _files(path, "hydro", snapname):
        gpos, gvel, gmass, gu, grho, gz = read_amr_gas(
            path, snapname, hdr, jitter_seed=jitter_seed)
        n = len(gmass)
        parts.append((gpos, gvel, gmass,
                      np.arange(1, n + 1, dtype=np.int64) + (1 << 40),
                      np.full(n, 0, np.int8), gu, gz, np.zeros(n)))

    pos = np.concatenate([p[0] for p in parts]) if parts else np.zeros((0, 3))
    vel = np.concatenate([p[1] for p in parts]) if parts else np.zeros((0, 3))
    mass = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0)
    pid = np.concatenate([p[3] for p in parts]) if parts \
        else np.zeros(0, np.int64)
    ptype = np.concatenate([p[4] for p in parts]) if parts \
        else np.zeros(0, np.int8)
    u = np.concatenate([p[5] for p in parts]) if parts else np.zeros(0)
    zmet = np.concatenate([p[6] for p in parts]) if parts else np.zeros(0)
    tage = np.concatenate([p[7] for p in parts]) if parts else np.zeros(0)

    # unit conversions (reference :607-620): code -> kpc, km/s, Msun.
    # Positions are code units in [0, boxlen]; boxsize = boxlen * lscale.
    extras = {"u": u.astype(np.float32), "sfr": np.zeros(len(u), np.float32),
              "zmet": zmet.astype(np.float32),
              "tage": tage.astype(np.float32)}
    return (hdr, (pos * hdr.lscale).astype(np.float64),
            (vel * hdr.vscale).astype(np.float64), pid.astype(np.int64),
            ptype, (mass * hdr.mscale).astype(np.float64), extras)
