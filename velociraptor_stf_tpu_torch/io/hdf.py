"""HDF5 snapshot reader for the conventions the reference supports.

The port's copy of ``velociraptor_stf_tpu/io/hdf.py``, kept so that
the port imports nothing of the JAX package.

Reference: reference hdfio.cxx:69 ``ReadHDF`` with the 8 naming
conventions of hdfitems.h:72-82 (ILLUSTRIS, GADGETX, EAGLE, GIZMO, SIMBA,
MUFASA, SWIFT-EAGLE, EAGLE-v2).  All of them share the Gadget-HDF layout
(``PartTypeX/{Coordinates,Velocities,ParticleIDs,Masses}``); they differ in
header attribute names/locations and in the extra baryon fields.  This
reader handles the shared layout plus the per-convention header quirks and
multi-file snapshots; baryon extras (u, SFR, Z, age) load when present.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import numpy as np

# naming conventions (reference hdfitems.h:74-82)
HDFILLUSTRISNAMES = 0
HDFGADGETXNAMES = 1
HDFEAGLENAMES = 2
HDFGIZMONAMES = 3
HDFSIMBANAMES = 4
HDFMUFASANAMES = 5
HDFSWIFTEAGLENAMES = 6
HDFEAGLEVERSION2NAMES = 7


def _convention_names(convention: int) -> Dict[str, List[str]]:
    """Primary dataset names per convention (reference HDF_Part_Info,
    hdfitems.h:343-560), each followed by generic fallbacks so partially
    conforming snapshots still load.

    EAGLE (classic) uses singular Velocity/Mass; ILLUSTRIS prefixes GFM_;
    GIZMO stores the total metal fraction as Metallicity_00; SIMBA/MUFASA
    store an 11-element Metallicity vector (first entry = total); SWIFT
    uses plural dataset names and birth scale factors for stellar ages.
    """
    vel = ["Velocities"]
    mass = ["Masses"]
    sfr = ["StarFormationRate"]
    zmet = ["Metallicity"]
    tage = ["StellarFormationTime"]
    u = ["InternalEnergy"]
    if convention == HDFEAGLENAMES:
        vel = ["Velocity", "Velocities"]
        mass = ["Mass", "Masses"]
    elif convention == HDFILLUSTRISNAMES:
        zmet = ["GFM_Metallicity", "Metallicity"]
        tage = ["GFM_StellarFormationTime", "StellarFormationTime"]
    elif convention == HDFGIZMONAMES:
        zmet = ["Metallicity_00", "Metallicity"]
    elif convention in (HDFSIMBANAMES, HDFMUFASANAMES):
        zmet = ["Metallicity"]
    elif convention == HDFSWIFTEAGLENAMES:
        u = ["InternalEnergies", "InternalEnergy"]
        sfr = ["StarFormationRates", "StarFormationRate"]
        zmet = ["MetalMassFractions", "SmoothedMetalMassFractions",
                "Metallicity"]
        tage = ["BirthScaleFactors", "StellarFormationTime"]
    elif convention == HDFEAGLEVERSION2NAMES:
        zmet = ["SmoothedMetallicity", "Metallicity"]
    # generic fallbacks shared by every convention
    vel += ["Velocity"] if "Velocity" not in vel else []
    mass += ["Mass"] if "Mass" not in mass else []
    u += ["InternalEnergies", "Thermal_Energy"]
    sfr += ["StarFormationRates", "SFR"]
    zmet += ["GFM_Metallicity", "MetalMassFractions", "SmoothedMetallicity",
             "Metallicities"]
    tage += ["BirthScaleFactors", "GFM_StellarFormationTime", "StellarAge"]
    bhmdot = ["BH_Mdot", "AccretionRates", "Mdot"]
    dedup = lambda xs: list(dict.fromkeys(xs))
    return {"vel": dedup(vel), "mass": dedup(mass), "u": dedup(u),
            "sfr": dedup(sfr), "zmet": dedup(zmet), "tage": dedup(tage),
            "bhmdot": dedup(bhmdot)}


@dataclass
class HdfHeader:
    boxsize: float = 0.0
    time: float = 1.0
    redshift: float = 0.0
    omega0: float = 0.0
    omega_lambda: float = 0.0
    hubble_param: float = 1.0
    num_files: int = 1
    npart_total: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.int64))
    mass_table: np.ndarray = field(
        default_factory=lambda: np.zeros(6, np.float64))


def _attr(g, *names, default=None):
    for nm in names:
        if nm in g.attrs:
            v = g.attrs[nm]
            return v
    return default


def read_hdf_header(fname: str, convention: int = HDFEAGLENAMES) -> HdfHeader:
    import h5py

    with h5py.File(fname, "r") as f:
        h = f["Header"]
        cos = f["Cosmology"] if "Cosmology" in f else h
        hdr = HdfHeader()
        bs = _attr(h, "BoxSize", default=0.0)
        bs = np.atleast_1d(np.asarray(bs, np.float64))
        hdr.boxsize = float(bs[0])
        hdr.time = float(np.atleast_1d(
            _attr(h, "Time", "Scale-factor", "ExpansionFactor",
                  default=1.0))[0])
        hdr.redshift = float(np.atleast_1d(
            _attr(h, "Redshift", default=0.0))[0])
        hdr.omega0 = float(np.atleast_1d(
            _attr(cos, "Omega0", "Omega_m", "Omega_b", default=0.0))[0])
        hdr.omega_lambda = float(np.atleast_1d(
            _attr(cos, "OmegaLambda", "Omega_lambda", default=0.0))[0])
        hdr.hubble_param = float(np.atleast_1d(
            _attr(cos, "HubbleParam", "h", default=1.0))[0])
        hdr.num_files = int(np.atleast_1d(
            _attr(h, "NumFilesPerSnapshot", "NumFiles", default=1))[0])
        npt = _attr(h, "NumPart_Total", "TotNumPart")
        if npt is not None:
            npt = np.asarray(npt, np.int64)
            hw = _attr(h, "NumPart_Total_HighWord")
            if hw is not None:
                npt = npt + (np.asarray(hw, np.int64) << 32)
            hdr.npart_total[: len(npt)] = npt[:6]
        mt = _attr(h, "MassTable", "InitialMassTable")
        if mt is not None:
            mt = np.asarray(mt, np.float64)
            hdr.mass_table[: len(mt)] = mt[:6]
        return hdr


def _snapshot_files(fname: str) -> List[str]:
    if os.path.exists(fname):
        try:
            hdr = read_hdf_header(fname)
            if hdr.num_files <= 1:
                return [fname]
        except Exception:
            return [fname]
    base, ext = os.path.splitext(fname)
    cand = f"{base}.0{ext}"
    if os.path.exists(cand):
        hdr = read_hdf_header(cand)
        return [f"{base}.{i}{ext}" for i in range(max(1, hdr.num_files))]
    if os.path.exists(fname):
        return [fname]
    raise FileNotFoundError(fname)


def read_hdf(fname: str, parttypes: Optional[List[int]] = None,
             convention: int = HDFEAGLENAMES, pos_dtype=np.float32,
             load_baryon_extras: bool = True, nsnapread: int = 1):
    """Read a (multi-file) HDF5 snapshot in any supported convention.

    Returns (header, pos, vel, pids, ptype, mass, extras) where extras is a
    dict of optional per-particle baryon arrays (u, sfr, zmet, tage) aligned
    with the particle axis (zero where absent).

    ``nsnapread > 1`` reads that many snapshot files concurrently (the
    analog of the reference's ``-Z`` read-rank split,
    ``MPIDistributeReadTasks`` mpiroutines.cxx:527-782; h5py releases the
    GIL during dataset I/O so per-file reads overlap).
    """
    files = _snapshot_files(fname)
    hdr = read_hdf_header(files[0], convention)
    types = parttypes if parttypes is not None else list(range(6))
    names = _convention_names(convention)

    read_one = partial(_read_hdf_file, types=types, names=names, hdr=hdr,
                       pos_dtype=pos_dtype,
                       load_baryon_extras=load_baryon_extras)
    if nsnapread > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(nsnapread, len(files))) as ex:
            parts = list(ex.map(read_one, files))
    else:
        parts = [read_one(fn) for fn in files]

    poss, vels, idss, typs, masss = [], [], [], [], []
    extras: Dict[str, List[np.ndarray]] = {k: [] for k in
                                           ("u", "sfr", "zmet", "tage",
                                            "bhmdot")}
    for (ps, vs, ids, ts, ms, ex_f) in parts:
        poss += ps
        vels += vs
        idss += ids
        typs += ts
        masss += ms
        for k in extras:
            extras[k] += ex_f[k]
    if not poss:
        raise ValueError(f"no particles of types {types} in {fname}")
    out_extras = {k: np.concatenate(v) for k, v in extras.items()
                  if load_baryon_extras}
    return (hdr, np.concatenate(poss), np.concatenate(vels),
            np.concatenate(idss), np.concatenate(typs),
            np.concatenate(masss), out_extras)


def _read_hdf_file(fn: str, *, types, names, hdr, pos_dtype,
                   load_baryon_extras):
    """One snapshot file -> per-type list tuple (pos, vel, id, type, mass,
    extras-dict)."""
    import h5py

    def _first(g, cands, dtype=pos_dtype):
        for c in cands:
            if c in g:
                a = np.asarray(g[c], dtype)
                return a if a.ndim == 1 else a[:, 0]
        return None

    poss, vels, idss, typs, masss = [], [], [], [], []
    extras: Dict[str, List[np.ndarray]] = {k: [] for k in
                                           ("u", "sfr", "zmet", "tage",
                                            "bhmdot")}
    with h5py.File(fn, "r") as f:
        for t in types:
            key = f"PartType{t}"
            if key not in f:
                continue
            g = f[key]
            if "Coordinates" not in g:
                continue
            p = np.asarray(g["Coordinates"], pos_dtype)
            n = len(p)
            if n == 0:
                continue
            vname = next((c for c in names["vel"] if c in g), None)
            v = np.asarray(g[vname], pos_dtype) if vname \
                else np.zeros_like(p)
            pid = np.asarray(g["ParticleIDs"]) if "ParticleIDs" in g \
                else np.arange(n, dtype=np.int64)
            m = _first(g, names["mass"])
            if m is None:
                m = np.full(n, hdr.mass_table[t], pos_dtype)
            poss.append(p)
            vels.append(v)
            idss.append(pid)
            typs.append(np.full(n, t, np.int8))
            masss.append(m)
            if load_baryon_extras:
                for ek in ("u", "sfr", "zmet", "tage", "bhmdot"):
                    arr = _first(g, names[ek])
                    extras[ek].append(
                        arr if arr is not None else np.zeros(n, pos_dtype))
    return poss, vels, idss, typs, masss, extras
