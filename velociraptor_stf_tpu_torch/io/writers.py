"""Catalog writers: .properties / .catalog_* / .hierarchy / metadata.

The port's copy of ``velociraptor_stf_tpu/io/writers.py``, kept so that
the port imports nothing of the JAX package.

Equivalent of the reference output layer
(reference io.cxx): ``WriteProperties``:1570 (HDF dataset names
from ``PropDataHeader``, allvars.h:3305), ``WriteGroupCatalog``:377,
``WriteGroupPartType``:936, ``WriteHierarchy``:3128, ``WriteFOF``:252, and
the run metadata writers ``WriteVELOCIraptorConfig``:3658 (.configuration),
``WriteSimulationInfo``:3698 (.siminfo), ``WriteUnitInfo``:3737 (.units).

Formats: HDF5 (``Binary_output=2``), raw binary streams (``Binary_output=1``,
matching the reference fwrite layout with Int_t = int64, the LONG_INT
default), and ASCII (``Binary_output=0``).  Single-file output (the MPI
per-rank ``name.N`` split collapses on a single-controller TPU run:
File_id=0, Num_of_files=1).
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional

import numpy as np

from ..utils import config as C


_INT_T = np.int64     # reference Int_t under VR_LONG_INT (CMakeLists.txt:43)


def _bin_header(f, *counts):
    """Raw-binary file header: int32 ThisTask, int32 NProcs, then the given
    64-bit counts (reference io.cxx:440-444 and siblings; single-controller
    run => task 0 of 1)."""
    np.asarray([0, 1], np.int32).tofile(f)
    for c in counts:
        np.asarray([c], np.uint64).tofile(f)


def _halo_ids(ngroups: int, snapshotvalue: int) -> np.ndarray:
    """Temporally unique halo ids (reference: snapvalue*1e12 + gid)."""
    base = np.int64(snapshotvalue) * np.int64(1000000000000)
    return base + np.arange(1, ngroups + 1, dtype=np.int64)


def properties_table(opt: C.Options, props: Dict[str, np.ndarray],
                     ngroups: int,
                     hostid: Optional[np.ndarray] = None,
                     parent: Optional[np.ndarray] = None,
                     numsubstruct: Optional[np.ndarray] = None,
                     id_mbp: Optional[np.ndarray] = None,
                     id_minpot: Optional[np.ndarray] = None,
                     pos_mbp: Optional[np.ndarray] = None,
                     pos_minpot: Optional[np.ndarray] = None,
                     vel_mbp: Optional[np.ndarray] = None,
                     vel_minpot: Optional[np.ndarray] = None,
                     efrac: Optional[np.ndarray] = None,
                     epot: Optional[np.ndarray] = None,
                     level: Optional[np.ndarray] = None,
                     stype: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    """Assemble the .properties column dict with reference field names
    (PropDataHeader, allvars.h:3314-...)."""
    g = slice(1, ngroups + 1)
    z = np.zeros(ngroups)
    zi = np.zeros(ngroups, np.int64)

    def get(key, default=None):
        if key in props:
            return np.asarray(props[key])[g]
        return z.copy() if default is None else default

    gcm = np.asarray(props["gcm"])[g]
    gcmvel = np.asarray(props["gcmvel"])[g]
    vd = np.asarray(props["gveldisp"])[g]
    J = np.asarray(props["gJ"])[g]
    eig = np.asarray(props.get("geigvec", np.zeros((ngroups + 1, 3, 3))))[g]
    M200c = get("gM200c")
    R200c = get("gR200c")
    vmax = get("gmaxvel")
    # Bullock spin lambda_B = |J| / (sqrt(2) M200c V200c R200c)
    with np.errstate(divide="ignore", invalid="ignore"):
        v200 = np.sqrt(np.where(R200c > 0, opt.G * M200c / R200c, 0.0))
        lamB = np.linalg.norm(J, axis=1) / \
            (np.sqrt(2.0) * M200c * v200 * R200c)
    lamB = np.nan_to_num(lamB, nan=0.0, posinf=0.0)

    pmb = pos_mbp if pos_mbp is not None else gcm
    pmp = pos_minpot if pos_minpot is not None else gcm
    vmb = vel_mbp if vel_mbp is not None else gcmvel
    vmp = vel_minpot if vel_minpot is not None else gcmvel

    cols = {
        "ID": _halo_ids(ngroups, opt.snapshotvalue),
        "ID_mbp": id_mbp if id_mbp is not None else zi.copy(),
        "ID_minpot": id_minpot if id_minpot is not None else zi.copy(),
        "hostHaloID": hostid[g].astype(np.int64) if hostid is not None
        else np.full(ngroups, -1, np.int64),
        "numSubStruct": numsubstruct[g].astype(np.int64)
        if numsubstruct is not None else zi.copy(),
        "npart": np.asarray(props["num"])[g].astype(np.uint64),
        # field halos HALOSTYPE=10; substructures 10+10*level; explicit
        # stype (iKeepFOF envelopes FOF3DTYPE) wins (reference
        # search.cxx:2786 stypeinlevel)
        "Structuretype": (stype[g].astype(np.int32) if stype is not None
                          else C.HALOSTYPE +
                          10 * (level[g].astype(np.int32)
                                if level is not None
                                else np.zeros(ngroups, np.int32))),
        "Mvir": get("gMvir"),
        "Xc": gcm[:, 0], "Yc": gcm[:, 1], "Zc": gcm[:, 2],
        "Xcmbp": pmb[:, 0], "Ycmbp": pmb[:, 1], "Zcmbp": pmb[:, 2],
        "Xcminpot": pmp[:, 0], "Ycminpot": pmp[:, 1], "Zcminpot": pmp[:, 2],
        "VXc": gcmvel[:, 0], "VYc": gcmvel[:, 1], "VZc": gcmvel[:, 2],
        "VXcmbp": vmb[:, 0], "VYcmbp": vmb[:, 1], "VZcmbp": vmb[:, 2],
        "VXcminpot": vmp[:, 0], "VYcminpot": vmp[:, 1],
        "VZcminpot": vmp[:, 2],
        "Mass_tot": get("gmass"),
        "Mass_FOF": get("gmass"),
        "Mass_200mean": get("gM200m"),
        "Mass_200crit": M200c,
        "Mass_BN98": get("gMBN98"),
        "Efrac": efrac if efrac is not None else
        (np.asarray(props["Efrac"])[g] if "Efrac" in props
         else np.ones(ngroups)),
        "Rvir": get("gRvir"),
        "R_size": get("gsize"),
        "R_200mean": get("gR200m"),
        "R_200crit": R200c,
        "R_BN98": get("gRBN98"),
        "R_HalfMass": get("gRhalfmass"),
        "Rmax": get("gRmaxvel"),
        "Vmax": vmax,
        "sigV": get("gsigma_v"),
        "lambda_B": lamB,
        "Lx": J[:, 0], "Ly": J[:, 1], "Lz": J[:, 2],
        "q": get("gq"), "s": get("gs"),
        "cNFW": get("cNFW"),
        "Krot": get("Krot"),
        "Ekin": get("Ekin"),
        "Epot": epot if epot is not None else
        (np.asarray(props["Epot"])[g] if "Epot" in props else z.copy()),
    }
    for i, a in enumerate("xyz"):
        for j, b in enumerate("xyz"):
            cols[f"veldisp_{a}{b}"] = vd[:, i, j]
            cols[f"eig_{a}{b}"] = eig[:, i, j]
    if "Efrac" in props:
        cols["Efrac"] = np.asarray(props["Efrac"])[g]
    if "Epot" in props:
        cols["Epot"] = np.asarray(props["Epot"])[g]
    # aperture columns (reference Aperture_mass_<value>_kpc naming)
    for ai, a in enumerate(opt.aperture_values_kpc):
        for src_key, out_key in ((f"Aperture_mass_{ai}", "Aperture_mass"),
                                 (f"Aperture_npart_{ai}", "Aperture_npart"),
                                 (f"Aperture_veldisp_{ai}",
                                  "Aperture_veldisp"),
                                 (f"Aperture_rhalfmass_{ai}",
                                  "Aperture_rhalfmass")):
            if src_key in props:
                cols[f"{out_key}_{a:g}_kpc"] = np.asarray(props[src_key])[g]
    for ai, a in enumerate(opt.aperture_proj_values_kpc):
        for pi, tag in enumerate(("xy", "xz", "yz")):
            k2 = f"Projected_aperture_{ai}_mass_proj{pi}"
            if k2 in props:
                cols[f"Projected_aperture_{a:g}_kpc_mass_{tag}"] = \
                    np.asarray(props[k2])[g]
    # RVmax columns
    if "RVmax_sigV" in props:
        cols["RVmax_sigV"] = np.asarray(props["RVmax_sigV"])[g]
        RJ = np.asarray(props["RVmax_L"])[g]
        cols["RVmax_Lx"], cols["RVmax_Ly"], cols["RVmax_Lz"] = \
            RJ[:, 0], RJ[:, 1], RJ[:, 2]
        cols["RVmax_q"] = np.asarray(props["RVmax_q"])[g]
        cols["RVmax_s"] = np.asarray(props["RVmax_s"])[g]
        rvd = np.asarray(props["RVmax_veldisp"])[g]
        rev = np.asarray(props["RVmax_eigvec"])[g]
        for i, a in enumerate("xyz"):
            for j, b in enumerate("xyz"):
                cols[f"RVmax_veldisp_{a}{b}"] = rvd[:, i, j]
                cols[f"RVmax_eig_{a}{b}"] = rev[:, i, j]
    # SO list columns (reference: SO_Mass_<value>_rhocrit etc.)
    if "SO_mass" in props and props["SO_mass"].shape[-1] > 0:
        for i, thr in enumerate(opt.SOthresholds_values_crit):
            tag = f"{thr:g}_rhocrit"
            cols[f"SO_Mass_{tag}"] = np.asarray(props["SO_mass"])[g][:, i]
            cols[f"SO_R_{tag}"] = np.asarray(props["SO_radius"])[g][:, i]
    # per-type (gas/gas_sf/gas_nsf/star/BH/interloper) sub-properties
    # (reference PropData n_gas/M_gas/L_200crit_gas/q_star/...,
    # allvars.h:1322-1528).  Vector fields expand to _x/_y/_z (L_* to
    # Lx_*), 3x3 tensors to _ab component columns.
    pertype = ("gas", "gas_sf", "gas_nsf", "star", "bh", "interloper")
    for t in pertype:
        if f"n_{t}" not in props:
            continue
        cols[f"n_{t}"] = np.asarray(props[f"n_{t}"])[g].astype(np.uint64)
        for key in sorted(props):
            if not key.endswith(f"_{t}") or key == f"n_{t}":
                continue
            if key in (f"cm_{t}", f"cmvel_{t}", f"L_{t}", f"veldisp_{t}",
                       f"eigvec_{t}"):
                continue
            # reference output schema (allvars.h:3540-3543 PropDataHeader):
            # the mass-weighted mean temperature lands in "T_<t>"; the raw
            # Temp/SFR-mean accumulators are internal-only and not written
            if key == f"Temp_mean_{t}":
                cols[f"T_{t}"] = np.asarray(props[key])[g]
                continue
            if key in (f"Temp_{t}", f"SFR_mean_{t}"):
                continue
            v = np.asarray(props[key])[g]
            if v.ndim == 1:
                cols[key] = v
            elif v.ndim == 2 and v.shape[1] == 3:   # L_<scope>_<t> vectors
                if key.startswith("L_"):
                    rest = key[2:]
                    cols[f"Lx_{rest}"] = v[:, 0]
                    cols[f"Ly_{rest}"] = v[:, 1]
                    cols[f"Lz_{rest}"] = v[:, 2]
                else:
                    for i, a in enumerate("xyz"):
                        cols[f"{key}_{a}"] = v[:, i]
        if f"cm_{t}" in props:
            cmt = np.asarray(props[f"cm_{t}"])[g]
            cmvt = np.asarray(props[f"cmvel_{t}"])[g]
            for i, a in enumerate("xyz"):
                cols[f"{a.upper()}c_{t}"] = cmt[:, i]
                cols[f"V{a.upper()}c_{t}"] = cmvt[:, i]
        if f"L_{t}" in props:
            Lt = np.asarray(props[f"L_{t}"])[g]
            cols[f"Lx_{t}"], cols[f"Ly_{t}"], cols[f"Lz_{t}"] = \
                Lt[:, 0], Lt[:, 1], Lt[:, 2]
        if f"veldisp_{t}" in props:
            vdt = np.asarray(props[f"veldisp_{t}"])[g]
            evt = np.asarray(props[f"eigvec_{t}"])[g]
            for i, a in enumerate("xyz"):
                for j, b in enumerate("xyz"):
                    cols[f"veldisp_{a}{b}_{t}"] = vdt[:, i, j]
                    cols[f"eig_{a}{b}_{t}"] = evt[:, i, j]
    # mass-weighted mean stellar age: reference column "tage_star"
    # (allvars.h:3628)
    if "t_mean_star" in props:
        cols["tage_star"] = np.asarray(props["t_mean_star"])[g]
    for k in ("M_bh_mostmassive", "acc_bh", "acc_bh_mostmassive"):
        if k in props:
            cols[k] = np.asarray(props[k])[g]
    # exclusive (member-only) masses when inclusive masses are active
    # (reference Mass_200crit_excl etc., io.cxx/allvars.h PropDataHeader)
    if opt.iInclusiveHalo > 0 and "gM200c_excl" in props:
        for src, dst in (("gM200m_excl", "Mass_200mean_excl"),
                         ("gM200c_excl", "Mass_200crit_excl"),
                         ("gMBN98_excl", "Mass_BN98_excl"),
                         ("gR200m_excl", "R_200mean_excl"),
                         ("gR200c_excl", "R_200crit_excl"),
                         ("gRBN98_excl", "R_BN98_excl")):
            cols[dst] = np.asarray(props[src])[g]
    return cols


def _file_header_attrs(opt: C.Options, ngroups: int) -> Dict[str, np.ndarray]:
    return {
        "File_id": np.int32(0),
        "Num_of_files": np.int32(1),
        "Num_of_groups": np.uint64(ngroups),
        "Total_num_of_groups": np.uint64(ngroups),
        "Cosmological_Sim": np.uint32(opt.icosmologicalin),
        "Comoving_or_Physical": np.uint32(opt.icomoveunit),
        "Period": np.float64(opt.p),
        "Time": np.float64(opt.a),
        "Length_unit_to_kpc": np.float64(opt.lengthtokpc),
        "Velocity_to_kms": np.float64(opt.velocitytokms),
        "Mass_unit_to_solarmass": np.float64(opt.masstosolarmass),
    }


def write_properties(opt: C.Options, outname: str, cols: Dict[str, np.ndarray],
                     ngroups: int):
    """.properties file (reference WriteProperties, io.cxx:1570)."""
    if opt.ibinaryout == C.OUTHDF:
        import h5py

        with h5py.File(f"{outname}.properties", "w") as f:
            for k, v in _file_header_attrs(opt, ngroups).items():
                f.create_dataset(k, data=v)
            for k, v in cols.items():
                f.create_dataset(k, data=v)
    elif opt.ibinaryout == C.OUTBINARY:
        # raw stream (reference io.cxx:1573-1580 + PropData::WriteBinary,
        # allvars.h:2291): header ints + 64-bit group counts + int32 column
        # count, then per-group packed values in PropDataHeader column
        # order — 8-byte ids/counts, 4-byte Structuretype, float64 values
        def _bdt(k, a):
            if k == "Structuretype":
                return np.uint32
            return _INT_T if np.issubdtype(a.dtype, np.integer) \
                else np.float64

        keys = list(cols.keys())
        rec = np.dtype([(k, _bdt(k, np.asarray(cols[k])))
                        for k in keys])
        table = np.zeros(ngroups, rec)
        for k in keys:
            table[k] = np.asarray(cols[k])
        with open(f"{outname}.properties", "wb") as f:
            np.asarray([0, 1], np.int32).tofile(f)
            np.asarray([ngroups, ngroups], np.uint64).tofile(f)
            np.asarray([len(keys)], np.int32).tofile(f)
            table.tofile(f)
    else:
        # reference ASCII layout (io.cxx:1699-1727): "task nprocs" /
        # "ng ngtot" / name(i) header items each followed by a space /
        # setprecision(10) rows in PropDataHeader column order — integer
        # columns written as integers (IDs above 2^53 would corrupt
        # through a float64 round trip)
        keys = list(cols.keys())
        with open(f"{outname}.properties", "w") as f:
            f.write(f"0 1\n{ngroups} {ngroups}\n")
            f.write("".join(f"{k}({i+1}) " for i, k in enumerate(keys))
                    + "\n")
            arrs = [np.asarray(cols[k]) for k in keys]
            fmts = ["%d" if np.issubdtype(a.dtype, np.integer) else "%.10g"
                    for a in arrs]
            for row in range(ngroups):
                f.write(" ".join(fmt % a[row]
                                 for fmt, a in zip(fmts, arrs)) + "\n")


def _stable_order(keys: np.ndarray) -> np.ndarray:
    """int32 permutation sorting int32 ``keys`` stably."""
    return np.argsort(np.ascontiguousarray(keys, np.int32),
                      kind="stable").astype(np.int32)


def write_group_catalog(opt: C.Options, outname: str, pfof: np.ndarray,
                        pids: np.ndarray, ngroups: int,
                        order_within_group: Optional[np.ndarray] = None,
                        bound_mask: Optional[np.ndarray] = None,
                        ptype: Optional[np.ndarray] = None):
    """.catalog_groups / .catalog_particles(.unbound) /
    .catalog_parttypes(.unbound) (reference io.cxx:377,936).

    ``order_within_group``: optional global permutation placing particles in
    output order (e.g. binding-energy sorted); defaults to index order.
    ``bound_mask``: particles failing it go to the .unbound files.
    """
    n = len(pfof)
    if order_within_group is None:
        # stable group sort (the JAX package's native counting sort gives
        # the same permutation)
        order_within_group = _stable_order(pfof)
    perm = order_within_group
    gsel = pfof[perm] > 0
    perm = perm[gsel]
    gids = pfof[perm]
    bound = np.ones(len(perm), bool) if bound_mask is None \
        else bound_mask[perm]

    # bound first within each group, preserving order: stable sort on the
    # composite (group id, unbound flag) key
    key2 = (gids.astype(np.int64) * 2 + (~bound)).astype(np.int32)
    order2 = _stable_order(key2)
    perm = perm[order2]
    gids = gids[order2]
    bound = bound[order2]

    sizes = np.bincount(gids, minlength=ngroups + 1)[1:ngroups + 1]
    nb_sizes = np.bincount(gids[bound], minlength=ngroups + 1)[1:ngroups + 1]
    # offsets into the bound and unbound pid lists
    off_bound = np.concatenate([[0], np.cumsum(nb_sizes)])[:-1]
    nub_sizes = sizes - nb_sizes
    off_unbound = np.concatenate([[0], np.cumsum(nub_sizes)])[:-1]

    pid_bound = pids[perm[bound]]
    pid_unbound = pids[perm[~bound]]
    typ_bound = ptype[perm[bound]] if ptype is not None else None
    typ_unbound = ptype[perm[~bound]] if ptype is not None else None

    if opt.ibinaryout == C.OUTBINARY:
        # reference io.cxx:416-646: .catalog_groups = header + sizes +
        # bound offsets + unbound offsets; .catalog_particles(.unbound) =
        # header + Int_t ids; .catalog_parttypes(.unbound) = header +
        # int32 types (io.cxx:1048-1141)
        with open(f"{outname}.catalog_groups", "wb") as f:
            _bin_header(f, ngroups, ngroups)
            sizes.astype(_INT_T).tofile(f)
            off_bound.astype(_INT_T).tofile(f)
            off_unbound.astype(_INT_T).tofile(f)
        for nm, pidlist in ((".catalog_particles", pid_bound),
                            (".catalog_particles.unbound", pid_unbound)):
            with open(outname + nm, "wb") as f:
                _bin_header(f, len(pidlist), len(pidlist))
                pidlist.astype(_INT_T).tofile(f)
        if ptype is not None:
            for nm, tl in ((".catalog_parttypes", typ_bound),
                           (".catalog_parttypes.unbound", typ_unbound)):
                with open(outname + nm, "wb") as f:
                    _bin_header(f, len(tl), len(tl))
                    tl.astype(np.int32).tofile(f)
    elif opt.ibinaryout == C.OUTHDF:
        import h5py

        with h5py.File(f"{outname}.catalog_groups", "w") as f:
            for k, v in _file_header_attrs(opt, ngroups).items():
                f.create_dataset(k, data=v)
            f.create_dataset("Group_Size", data=sizes.astype(np.uint32))
            f.create_dataset("Offset", data=off_bound.astype(np.uint64))
            f.create_dataset("Offset_unbound",
                             data=off_unbound.astype(np.uint64))
        for nm, pidlist in ((".catalog_particles", pid_bound),
                            (".catalog_particles.unbound", pid_unbound)):
            with h5py.File(outname + nm, "w") as f:
                f.create_dataset("File_id", data=np.int32(0))
                f.create_dataset("Num_of_files", data=np.int32(1))
                f.create_dataset("Num_of_particles_in_groups",
                                 data=np.uint64(len(pidlist)))
                f.create_dataset("Total_num_of_particles_in_all_groups",
                                 data=np.uint64(len(pidlist)))
                f.create_dataset("Particle_IDs",
                                 data=pidlist.astype(np.int64))
        if ptype is not None:
            for nm, tl in ((".catalog_parttypes", typ_bound),
                           (".catalog_parttypes.unbound", typ_unbound)):
                with h5py.File(outname + nm, "w") as f:
                    f.create_dataset("File_id", data=np.int32(0))
                    f.create_dataset("Num_of_files", data=np.int32(1))
                    f.create_dataset("Num_of_particles_in_groups",
                                     data=np.uint64(len(tl)))
                    f.create_dataset("Total_num_of_particles_in_all_groups",
                                     data=np.uint64(len(tl)))
                    f.create_dataset("Particle_types",
                                     data=tl.astype(np.uint16))
    else:
        with open(f"{outname}.catalog_groups", "w") as f:
            f.write("0 1\n")
            f.write(f"{ngroups} {ngroups}\n")
            np.savetxt(f, sizes, fmt="%d")
            np.savetxt(f, off_bound, fmt="%d")
            np.savetxt(f, off_unbound, fmt="%d")
        for nm, pidlist in ((".catalog_particles", pid_bound),
                            (".catalog_particles.unbound", pid_unbound)):
            with open(outname + nm, "w") as f:
                f.write("0 1\n")
                f.write(f"{len(pidlist)} {len(pidlist)}\n")
                np.savetxt(f, pidlist, fmt="%d")
        if ptype is not None:
            # one type per line after the 2-line header (io.cxx:1141)
            for nm, tl in ((".catalog_parttypes", typ_bound),
                           (".catalog_parttypes.unbound", typ_unbound)):
                with open(outname + nm, "w") as f:
                    f.write("0 1\n")
                    f.write(f"{len(tl)} {len(tl)}\n")
                    np.savetxt(f, tl, fmt="%d")


def write_hierarchy(opt: C.Options, outname: str, parent: np.ndarray,
                    ngroups: int):
    """.hierarchy (reference WriteHierarchy, io.cxx:3128)."""
    # vectorised sub-count (a per-group Python loop is minutes of host
    # time at genesis-scale group counts)
    par = np.asarray(parent[1:ngroups + 1], np.int64)
    nsubs = np.zeros(ngroups + 1, np.int64)
    np.add.at(nsubs, par[par > 0], 1)
    parent_out = np.where(parent[1:ngroups + 1] > 0,
                          parent[1:ngroups + 1], -1).astype(np.int64)
    if opt.ibinaryout == C.OUTBINARY:
        # reference WriteHierarchy standalone-file branch (io.cxx:3282+):
        # header + nsub[1..ng] + parentgid[1..ng], Int_t streams
        with open(f"{outname}.hierarchy", "wb") as f:
            _bin_header(f, ngroups, ngroups)
            nsubs[1:].astype(_INT_T).tofile(f)
            parent_out.astype(_INT_T).tofile(f)
    elif opt.ibinaryout == C.OUTHDF:
        import h5py

        with h5py.File(f"{outname}.hierarchy", "w") as f:
            f.create_dataset("File_id", data=np.int32(0))
            f.create_dataset("Num_of_files", data=np.int32(1))
            f.create_dataset("Num_of_groups", data=np.uint64(ngroups))
            f.create_dataset("Total_num_of_groups", data=np.uint64(ngroups))
            f.create_dataset("Number_of_substructures_in_halo",
                             data=nsubs[1:].astype(np.uint32))
            f.create_dataset("Parent_halo_ID", data=parent_out)
    else:
        with open(f"{outname}.hierarchy", "w") as f:
            f.write("0 1\n")
            f.write(f"{ngroups} {ngroups}\n")
            np.savetxt(f, np.column_stack([nsubs[1:], parent_out]), fmt="%d")


def write_so_catalog(opt: C.Options, outname: str, so_offsets: np.ndarray,
                     so_indices: np.ndarray, pids: np.ndarray, ngroups: int,
                     ptype: Optional[np.ndarray] = None):
    """.catalog_SOlist (reference WriteSOCatalog, io.cxx:1157): particle IDs
    within each halo's largest SO sphere, CSR (Offset + SO_Size + IDs)."""
    sizes = np.diff(so_offsets).astype(np.uint32)
    spids = pids[so_indices]
    if opt.ibinaryout == C.OUTBINARY:
        # reference WriteSOCatalog binary (io.cxx:1209-1420): 6-value
        # header (task, nprocs, ng, ngtot, nSOids, nSOidstot) + per-group
        # sizes + offsets + particle ids, Int_t streams
        with open(f"{outname}.catalog_SOlist", "wb") as f:
            _bin_header(f, ngroups, ngroups, len(spids), len(spids))
            sizes.astype(_INT_T).tofile(f)
            so_offsets[:-1].astype(_INT_T).tofile(f)
            spids.astype(_INT_T).tofile(f)
    elif opt.ibinaryout == C.OUTHDF:
        import h5py

        with h5py.File(f"{outname}.catalog_SOlist", "w") as f:
            for k, v in _file_header_attrs(opt, ngroups).items():
                f.create_dataset(k, data=v)
            f.create_dataset("Num_of_particles_in_SO_regions",
                             data=np.uint64(len(spids)))
            f.create_dataset("Total_num_of_particles_in_SO_regions",
                             data=np.uint64(len(spids)))
            f.create_dataset("SO_size", data=sizes)
            f.create_dataset("Offset",
                             data=so_offsets[:-1].astype(np.uint64))
            f.create_dataset("Particle_IDs", data=spids.astype(np.int64))
            if ptype is not None:
                f.create_dataset("Particle_types",
                                 data=ptype[so_indices].astype(np.uint16))
    else:
        with open(f"{outname}.catalog_SOlist", "w") as f:
            f.write("0 1\n")
            f.write(f"{ngroups} {ngroups}\n")
            f.write(f"{len(spids)} {len(spids)}\n")
            np.savetxt(f, sizes, fmt="%d")
            np.savetxt(f, so_offsets[:-1], fmt="%d")
            np.savetxt(f, spids, fmt="%d")


def write_profiles(opt: C.Options, outname: str, props: Dict[str, np.ndarray],
                   ngroups: int, hostid: Optional[np.ndarray] = None):
    """.profiles (reference WriteProfiles, io.cxx:2756): radial mass /
    particle-count profiles per group plus the bin edges."""
    if "Mass_profile" not in props:
        return
    g = slice(1, ngroups + 1)
    mprof = np.asarray(props["Mass_profile"])[g]
    nprof = np.asarray(props["Npart_profile"])[g]
    edges = np.asarray(opt.profile_bin_edges, np.float64)
    hostid_out = (hostid[g].astype(np.int64) if hostid is not None
                  else np.full(ngroups, -1, np.int64))
    if opt.ibinaryout == C.OUTBINARY:
        # reference binary header (io.cxx:2779-2790); the reference's own
        # per-group binary profile write is a commented-out stub, so the
        # data section here (mass profile float64 rows + Int_t count rows)
        # is this repo's documented completion of that layout
        with open(f"{outname}.profiles", "wb") as f:
            _bin_header(f, ngroups, ngroups, ngroups, ngroups)
            np.asarray([opt.iprofilenorm, len(edges)], np.int32).tofile(f)
            edges.astype(np.float64).tofile(f)
            mprof.astype(np.float64).tofile(f)
            nprof.astype(_INT_T).tofile(f)
    elif opt.ibinaryout == C.OUTHDF:
        import h5py

        with h5py.File(f"{outname}.profiles", "w") as f:
            for k, v in _file_header_attrs(opt, ngroups).items():
                f.create_dataset(k, data=v)
            f.create_dataset("Radial_norm",
                             data=np.int32(opt.iprofilenorm))
            f.create_dataset("Num_of_bin_edges",
                             data=np.int32(len(edges)))
            f.create_dataset("Radial_bin_edges", data=edges)
            f.create_dataset("ID", data=_halo_ids(ngroups,
                                                  opt.snapshotvalue))
            f.create_dataset("hostHaloID", data=hostid_out)
            f.create_dataset("Mass_profile", data=mprof)
            f.create_dataset("Npart_profile",
                             data=nprof.astype(np.uint32))
    else:
        with open(f"{outname}.profiles", "w") as f:
            f.write("0 1\n")
            f.write(f"{ngroups} {ngroups}\n")
            f.write(" ".join(f"{e:g}" for e in edges) + "\n")
            for i in range(ngroups):
                f.write(" ".join(f"{x:.10g}" for x in mprof[i]) + "\n")


def write_fof_grp(outname: str, pfof: np.ndarray):
    """.fof.grp tipsy-style array file (reference WriteFOF, io.cxx:252)."""
    with open(f"{outname}.fof.grp", "w") as f:
        f.write(f"{len(pfof)}\n")
        np.savetxt(f, np.asarray(pfof, np.int64), fmt="%d")


def write_config_info(opt: C.Options, outname: str):
    """.configuration run metadata (reference WriteVELOCIraptorConfig,
    io.cxx:3658): key=value dump of the active options."""
    import dataclasses as _dc

    with open(f"{outname}.configuration", "w") as f:
        f.write(f"#VELOCIraptor-STF-TPU configuration, written "
                f"{_time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        for fld in _dc.fields(opt):
            v = getattr(opt, fld.name)
            if fld.name in ("unknown_keys",):
                continue
            if _dc.is_dataclass(v):
                for sf in _dc.fields(v):
                    f.write(f"{fld.name}.{sf.name}={getattr(v, sf.name)}\n")
            elif isinstance(v, list):
                f.write(f"{fld.name}={','.join(str(x) for x in v)}\n")
            else:
                f.write(f"{fld.name}={v}\n")


def write_sim_info(opt: C.Options, outname: str):
    """.siminfo (reference WriteSimulationInfo, io.cxx:3698)."""
    with open(f"{outname}.siminfo", "w") as f:
        for k, v in (
            ("Cosmological_Sim", opt.icosmologicalin),
            ("ScaleFactor", opt.a),
            ("h_val", opt.h),
            ("Omega_m", opt.Omega_m),
            ("Omega_Lambda", opt.Omega_Lambda),
            ("Omega_b", opt.Omega_b),
            ("Omega_cdm", opt.Omega_cdm),
            ("Omega_r", opt.Omega_r),
            ("Omega_nu", opt.Omega_nu),
            ("Omega_k", opt.Omega_k),
            ("Omega_DE", opt.Omega_de),
            ("w_of_DE", opt.w_de),
            ("Hubble_unit", opt.H),
            ("Period", opt.p),
            ("Critical_density", opt.rhocrit),
            ("Matter_density", opt.rhobg),
            ("Virial_density", opt.virlevel),
            ("BN98_density", opt.virBN98),
            ("Gravity", opt.G),
        ):
            f.write(f"{k} : {v}\n")


def write_unit_info(opt: C.Options, outname: str):
    """.units (reference WriteUnitInfo, io.cxx:3737)."""
    with open(f"{outname}.units", "w") as f:
        for k, v in (
            ("Length_unit_to_kpc", opt.lengthtokpc),
            ("Velocity_unit_to_kms", opt.velocitytokms),
            ("Mass_unit_to_solarmass", opt.masstosolarmass),
            ("Length_unit", opt.lengthinputconversion),
            ("Velocity_unit", opt.velocityinputconversion),
            ("Mass_unit", opt.massinputconversion),
            ("Gravity", opt.G),
            ("Hubble_unit", opt.H),
        ):
            f.write(f"{k} : {v}\n")


def write_extended_output(opt: C.Options, outname: str, pids: np.ndarray,
                          pfof: np.ndarray,
                          hostid: Optional[np.ndarray] = None,
                          stype: Optional[np.ndarray] = None,
                          file_counts: Optional[np.ndarray] = None):
    """``Extended_output=1`` per-particle extraction files (reference
    ``WriteExtendedOutput``, io.cxx:3826, EXTENDEDHALOOUTPUT build):

    * ``{outname}.filesofgroup`` — per group: a line ``haloid  nfiles``
      followed by a line listing the input-file indices holding the
      group's particles (io.cxx:3973-3981);
    * ``{outname}.extended.{F}`` — per input file F, one row per particle
      in that file's original order:  ``Id IdStruct IdHost IdTopHost``
      (widths 12/7/7/7, io.cxx:4197-4208), where Id is the particle id,
      IdStruct the temporally-unique halo id of its group
      (``pdata[pfof].haloid``), IdHost the top-level host's halo id (the
      group's own id for field objects — io.cxx:3896-3905 with
      noffset=0 on a single-controller run) and IdTopHost the 3DFOF
      envelope's halo id under ``iKeepFOF`` (``hostfofid``; the group's
      own id when no envelope hierarchy exists).

    ``file_counts``: particles per input file in global read order
    (reference ``GetOFile``/``GetOIndex`` provenance); default = one
    file holding everything (the single-controller ingest collapses the
    per-rank provenance the reference tracks through MPI).
    """
    pids = np.asarray(pids)
    pfof = np.asarray(pfof)
    n = len(pfof)
    if file_counts is None:
        file_counts = np.asarray([n])
    file_counts = np.asarray(file_counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(file_counts)])
    nfile = len(file_counts)
    ng = int(pfof.max(initial=0))
    base = np.int64(opt.snapshotvalue) * np.int64(1000000000000)

    # per-group id tables (indexed by raw gid; slot 0 = untagged)
    haloid_of = np.zeros(ng + 1, np.int64)
    haloid_of[1:] = base + np.arange(1, ng + 1, dtype=np.int64)
    gids = np.arange(ng + 1, dtype=np.int64)
    if hostid is not None:
        h = np.asarray(hostid[:ng + 1], np.int64)
        # reference: hostid < 0 (field) -> the group's own id (+noffset=0)
        idhost_of = np.where(h > 0, base + h, gids)
    else:
        idhost_of = gids.copy()
    # hostfofid: only the iKeepFOF 3DFOF envelopes qualify
    # (search.cxx:3649-3650); 0 elsewhere -> falls back to the group id
    hostfof_of = np.zeros(ng + 1, np.int64)
    if hostid is not None and stype is not None:
        st = np.asarray(stype[:ng + 1])
        h = np.asarray(hostid[:ng + 1], np.int64)
        hc = np.clip(h, 0, ng)
        env = (h > 0) & (st[hc] == C.FOF3DTYPE)
        hostfof_of = np.where(env, base + h, 0)
    idtop_of = np.where(hostfof_of == 0, gids, hostfof_of)
    idhost_of[0] = idtop_of[0] = 0

    # .filesofgroup: input-file indices holding each group's particles
    ofile = np.searchsorted(starts[1:], np.arange(n), side="right")
    with open(f"{outname}.filesofgroup", "w") as f:
        tagged = pfof > 0
        pairs = np.unique(np.stack([pfof[tagged], ofile[tagged]]), axis=1)
        goff = np.searchsorted(pairs[0], np.arange(1, ng + 2))
        for g in range(1, ng + 1):
            fl = pairs[1, goff[g - 1]:goff[g]]
            f.write(f"{haloid_of[g]}  {len(fl)}\n")
            f.write("".join(f"{fi} " for fi in fl) + "\n")

    # .extended.N: original within-file order (our ingest preserves read
    # order, so OIndex = global index - file start)
    id_struct = haloid_of[pfof]
    id_host = idhost_of[pfof]
    id_top = idtop_of[pfof]
    for fi in range(nfile):
        lo, hi = starts[fi], starts[fi + 1]
        if hi <= lo:
            continue
        with open(f"{outname}.extended.{fi}", "w") as f:
            rows = np.stack([pids[lo:hi].astype(np.int64),
                             id_struct[lo:hi], id_host[lo:hi],
                             id_top[lo:hi]], axis=1)
            np.savetxt(f, rows, fmt="%12d  %7d  %7d  %7d  ")
