"""Command-line entry point of the port (port of velociraptor_stf_tpu/cli.py:
``build_parser``, ``read_snapshot``, ``run`` and ``main``).

    python -m velociraptor_stf_tpu_torch.cli -C run.cfg -i snap -o out \\
        [-I 1] [--device cuda|cpu]

The same flags and config checks as the reference (reference ``main()`` /
``GetArgs``, main.cxx:20, ui.cxx:9); the search runs on ``--device``
(default ``cuda``, which needs a card: the run never falls back to the CPU)
and the catalogs go through the port's writers (``io/writers.py``).
The run is sharded over a mesh (``parallel/``) as ``_auto_mesh`` decides:
on ``cuda`` over every visible card when there are several, ``VR_MESH=N``
taking the first N (0 or 1: one device); on ``--device cpu`` over
``VR_MESH=N`` CPU shards, and on one device without it.  ``VR_PROFILE=
<dir>`` writes a ``torch.profiler`` trace of the search (Chrome trace
JSON) into ``<dir>``, as the reference writes its jax.profiler trace.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np
import torch

from .io import gadget as gadget_io
from .io import writers
from .models import pipeline, unbind as unbind_mod
from .utils import config as C
from .utils import units
from .utils.timing import PhaseTimer, profile_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vrtorch",
        description="VELOCIraptor halo finder, PyTorch/CUDA port")
    p.add_argument("-C", dest="config", required=True,
                   help="configuration file (reference keyword format)")
    p.add_argument("-i", dest="input", required=True, help="input snapshot")
    p.add_argument("-I", dest="inputtype", type=int, default=C.IOGADGET,
                   help="input type 1=gadget 2=hdf 3=tipsy 4=ramses "
                   "5=nchilada")
    p.add_argument("-s", dest="num_files", type=int, default=1)
    p.add_argument("-o", dest="output", default=None,
                   help="output base name (overrides config Output)")
    p.add_argument("-Z", dest="nsnapread", type=int, default=1)
    p.add_argument("-v", dest="verbose", type=int, default=None)
    p.add_argument("-G", dest="gnsphblocks", type=int, default=None,
                   help="number of extra gadget SPH blocks")
    p.add_argument("-S", dest="gnstarblocks", type=int, default=None,
                   help="number of extra gadget star blocks")
    p.add_argument("-B", dest="gnbhblocks", type=int, default=None,
                   help="number of extra gadget BH blocks")
    p.add_argument("-t", dest="ramsessnapname", default=None,
                   help="RAMSES snapshot naming (reference -t)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the search (default cuda)")
    return p


def read_snapshot(opt: C.Options):
    """Read the snapshot with the port's numpy readers; returns (pos,
    vel, pids, ptype, mass, boxsize, extras) in internal units (reference
    ReadData io.cxx:73).  The HDF readers need h5py only when asked for."""
    want_types = None
    if opt.partsearchtype == C.PSTDARK and not opt.iBaryonSearch:
        want_types = [1, 2, 3]
    elif opt.partsearchtype == C.PSTGAS:
        want_types = [0]
    elif opt.partsearchtype == C.PSTSTAR:
        want_types = [4]

    extras = None
    nread = max(1, int(getattr(opt, "nsnapread", 1)))
    if opt.inputtype == C.IOGADGET:
        hdr, pos, vel, pids, ptype, mass = gadget_io.read_gadget(
            opt.fname, parttypes=want_types, nsnapread=nread)
        boxsize = hdr.boxsize
        opt.a = hdr.time if opt.icosmologicalin else 1.0
        opt.Omega_m = hdr.omega0 or opt.Omega_m
        opt.Omega_Lambda = hdr.omega_lambda or opt.Omega_Lambda
        opt.h = hdr.hubble_param or opt.h
        ntot = hdr.ntotal
    elif opt.inputtype == C.IOHDF:
        from .io import hdf as hdf_io

        hdr, pos, vel, pids, ptype, mass, extras = hdf_io.read_hdf(
            opt.fname, parttypes=want_types,
            convention=opt.ihdfnameconvention, nsnapread=nread)
        if extras is not None and not any(
                np.abs(v).max() > 0 for v in extras.values() if len(v)):
            extras = None
        boxsize = hdr.boxsize
        opt.a = hdr.time if opt.icosmologicalin else 1.0
        opt.Omega_m = hdr.omega0 or opt.Omega_m
        opt.Omega_Lambda = hdr.omega_lambda or opt.Omega_Lambda
        opt.h = hdr.hubble_param or opt.h
        ntot = int(hdr.npart_total.sum()) or len(pos)
    elif opt.inputtype == C.IOTIPSY:
        from .io import tipsy as tipsy_io

        hdr, pos, vel, pids, ptype, mass = tipsy_io.read_tipsy(opt.fname)
        boxsize = opt.p
        ntot = len(pos)
    elif opt.inputtype == C.IORAMSES:
        from .io import ramses as ramses_io

        # snapshot directory; the snapshot number from its info file or
        # trailing digits (reference -i dir + ramsessnapname,
        # ramsesio.cxx:92-96)
        path = opt.fname.rstrip("/")
        snap = getattr(opt, "ramsessnapname", None)
        if not snap:
            infos = sorted(glob.glob(os.path.join(path, "info_*.txt")))
            if infos:
                snap = re.search(r"info_(\w+)\.txt$", infos[0]).group(1)
            else:
                m = re.search(r"(\d+)$", path)
                snap = m.group(1).zfill(5) if m else "00001"
        hdr, pos, vel, pids, ptype, mass, extras = ramses_io.read_ramses(
            path, snap, parttypes=want_types)
        boxsize = hdr.boxsize
        opt.a = hdr.aexp if opt.icosmologicalin else 1.0
        opt.Omega_m = hdr.omega_m or opt.Omega_m
        opt.Omega_Lambda = hdr.omega_l or opt.Omega_Lambda
        opt.h = (hdr.h0 / 100.0) or opt.h
        ntot = len(pos)
        if extras is not None and not any(
                np.abs(v).max() > 0 for v in extras.values() if len(v)):
            extras = None
    elif opt.inputtype == C.IONCHILADA:
        from .io import nchilada as nch_io

        hdr, pos, vel, pids, ptype, mass = nch_io.read_nchilada(
            opt.fname, parttypes=want_types)
        boxsize = opt.p
        opt.a = hdr.time if opt.icosmologicalin and hdr.time else opt.a
        ntot = len(pos)
    else:
        raise NotImplementedError(
            f"input type {opt.inputtype} not implemented "
            "(gadget=1, hdf=2, tipsy=3, ramses=4, nchilada=5)")

    if opt.lengthinputconversion != 1.0:
        pos = pos * opt.lengthinputconversion
        boxsize = boxsize * opt.lengthinputconversion
    if opt.velocityinputconversion != 1.0:
        vel = vel * opt.velocityinputconversion
    if opt.massinputconversion != 1.0:
        mass = mass * opt.massinputconversion
    # interparticle spacing -> linking length scale (reference
    # gadgetio.cxx:1417 / hdfio.cxx:1967)
    if opt.icosmologicalin and boxsize > 0:
        opt.ellxscale = units.interparticle_spacing(boxsize, ntot)
        opt.p = boxsize
    # zoom input (low-res DM types 2/3 or a DM mass spread): the linking
    # length follows the high-res spacing and heavier DM counts as
    # interloper (reference gadgetio.cxx:1370-1412, zoomlowmassdm)
    if ptype is not None:
        pt = np.asarray(ptype)
        dm = pt == 1
        lowres = (pt == 2) | (pt == 3)
        if dm.any():
            mp_dm = float(np.min(mass[dm]))
            multires = bool(lowres.any()) or \
                float(np.max(mass[dm])) > mp_dm * (1 + 1e-4)
            if multires:
                opt.zoomlowmassdm = mp_dm * (1 + 1e-4)
                if opt.icosmologicalin and boxsize > 0:
                    if opt.Neff > 0:
                        opt.ellxscale = boxsize / opt.Neff
                    else:
                        mtot_dm = float(mass[dm | lowres].sum())
                        neff = max(mtot_dm / mp_dm, 1.0) ** (1.0 / 3.0)
                        opt.ellxscale = boxsize / neff
    return (pos, vel, pids, ptype, mass,
            boxsize if boxsize > 0 else None, extras)


def _bound_order(opt: C.Options, res: pipeline.CatalogResult, vel, mass,
                 pos, pids, device):
    """Binding-energy order of the catalog's particles and the ID_mbp /
    ID_minpot columns with those particles' phase coordinates (reference
    gposmbp / gposminpot, substructureproperties.cxx:3970-3975; the CM
    where a group has none)."""
    ng = res.ngroups
    perm, mbp, minpot = unbind_mod.sort_by_binding_energy(
        torch.from_numpy(np.ascontiguousarray(vel, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(mass, np.float32)).to(device),
        torch.from_numpy(np.minimum(res.pfof, ng).astype(np.int64)).to(
            device),
        torch.from_numpy(res.W).to(device), ng,
        torch.from_numpy(res.props["gcmvel"]).to(device),
        by_energy=bool(opt.iSortByBindingEnergy))
    order = perm.cpu().numpy()
    mbp_np = mbp.cpu().numpy()[1:ng + 1]
    minpot_np = minpot.cpu().numpy()[1:ng + 1]
    okb = (mbp_np >= 0) & (mbp_np < len(pids))
    id_mbp = np.where(okb, pids[np.clip(mbp_np, 0, len(pids) - 1)], -1)
    id_minpot = np.where(okb, pids[np.clip(minpot_np, 0, len(pids) - 1)],
                         -1)
    pos, vel = np.asarray(pos), np.asarray(vel)
    gcm = res.props["gcm"][1:ng + 1]
    gcmv = res.props["gcmvel"][1:ng + 1]
    mb = np.clip(mbp_np, 0, len(pos) - 1)
    mp = np.clip(minpot_np, 0, len(pos) - 1)
    coords = dict(
        pos_mbp=np.where(okb[:, None], pos[mb], gcm),
        vel_mbp=np.where(okb[:, None], vel[mb], gcmv),
        pos_minpot=np.where(okb[:, None], pos[mp], gcm),
        vel_minpot=np.where(okb[:, None], vel[mp], gcmv))
    return order, id_mbp, id_minpot, coords


def _auto_mesh(device="cuda"):
    """The mesh of a run (the analog of launching the reference under
    mpirun, main.cxx:33), or None for one device: on ``cuda`` every
    visible card when there are more than one; on the CPU none.
    ``VR_MESH=N`` overrides: the first N cards, or N CPU shards; 0 or 1
    means one device."""
    from .parallel.mesh import make_mesh

    kind = torch.device(device).type
    want = os.environ.get("VR_MESH")
    if kind == "cuda":
        ndev = torch.cuda.device_count()
        if want is not None:
            ndev = min(int(want), ndev)
    else:
        ndev = 0 if want is None else int(want)
    return make_mesh(ndev, kind) if ndev > 1 else None


def run(opt: C.Options, device="cuda") -> pipeline.CatalogResult:
    """Read, search, write (reference main())."""
    timer = PhaseTimer(verbose=opt.iverbose)
    with timer.phase("read"):
        pos, vel, pids, ptype, mass, boxsize, extras = read_snapshot(opt)
    mesh = _auto_mesh(device)
    if mesh is not None and opt.iverbose:
        print(f"Running sharded over {mesh.size} shards")
    with profile_trace(os.environ.get("VR_PROFILE")):
        res = pipeline.find_structures(opt, pos, vel, mass, boxsize=boxsize,
                                       ptype=ptype, extras=extras,
                                       device=device, mesh=mesh)
    for k, v in res.timings.items():
        timer.record(k, v)

    with timer.phase("output"):
        ng = res.ngroups
        order_bind = id_mbp = id_minpot = None
        coords = dict(pos_mbp=None, vel_mbp=None, pos_minpot=None,
                      vel_minpot=None)
        if res.W is not None and ng > 0:
            order_bind, id_mbp, id_minpot, coords = _bound_order(
                opt, res, vel, mass, pos, pids, device)
        numsub = None
        if res.parent is not None:
            numsub = np.zeros(ng + 1, np.int64)
            par_ = np.asarray(res.parent[1:ng + 1], np.int64)
            np.add.at(numsub, par_[par_ > 0], 1)

        def _write_set(outname, sel_gids):
            """One catalog set of the groups ``sel_gids`` renumbered 1..k
            (``Separate_output_files``, reference main.cxx:469-523)."""
            k = len(sel_gids)
            gmap = np.zeros(ng + 1, np.int32)
            gmap[sel_gids] = np.arange(1, k + 1)
            rows = np.concatenate([[0], sel_gids])
            props_s = {key: np.asarray(v)[rows] for key, v in
                       res.props.items()}
            h = np.asarray(res.hostid)[rows]
            host_s = np.where(h > 0, gmap[np.clip(h, 0, ng)], -1)
            par_s = None
            if res.parent is not None:
                par_s = gmap[np.clip(np.asarray(res.parent)[rows], 0, ng)]
            lev_s = None if res.hierarchy_level is None else \
                np.asarray(res.hierarchy_level)[rows]
            sty_s = None if res.stype is None else \
                np.asarray(res.stype)[rows]
            sl = sel_gids - 1
            cols_s = writers.properties_table(
                opt, props_s, k, hostid=host_s,
                numsubstruct=None if numsub is None else numsub[rows],
                id_mbp=None if id_mbp is None else id_mbp[sl],
                id_minpot=None if id_minpot is None else id_minpot[sl],
                level=lev_s, stype=sty_s,
                **{key: None if v is None else v[sl]
                   for key, v in coords.items()})
            writers.write_properties(opt, outname, cols_s, k)
            writers.write_group_catalog(opt, outname, gmap[res.pfof], pids,
                                        k, order_within_group=order_bind,
                                        ptype=ptype)
            writers.write_hierarchy(
                opt, outname,
                par_s.astype(np.int64) if par_s is not None
                else np.zeros(k + 1, np.int64), k)

        if opt.iseparatefiles and res.hostid is not None:
            all_gids = np.arange(1, ng + 1)
            isfield = np.asarray(res.hostid[1:ng + 1]) == -1
            _write_set(opt.outname, all_gids[isfield])
            _write_set(opt.outname + ".sublevels", all_gids[~isfield])
        else:
            cols = writers.properties_table(
                opt, res.props, ng, hostid=res.hostid, numsubstruct=numsub,
                id_mbp=id_mbp, id_minpot=id_minpot,
                level=res.hierarchy_level, stype=res.stype, **coords)
            writers.write_properties(opt, opt.outname, cols, ng)
            writers.write_group_catalog(opt, opt.outname, res.pfof, pids,
                                        ng, order_within_group=order_bind,
                                        ptype=ptype)
            writers.write_hierarchy(
                opt, opt.outname,
                res.parent if res.parent is not None
                else np.zeros(ng + 1, np.int64), ng)
        if opt.isubfindoutput:
            # the property table as a .subproperties file (the reference's
            # WriteSUBFINDProperties, io.cxx:3483)
            cols_sf = writers.properties_table(
                opt, res.props, ng, hostid=res.hostid, numsubstruct=numsub,
                id_mbp=id_mbp, id_minpot=id_minpot,
                level=res.hierarchy_level, stype=res.stype)
            writers.write_properties(opt, opt.outname + ".subprop", cols_sf,
                                     ng)
            os.replace(opt.outname + ".subprop.properties",
                       opt.outname + ".subproperties")
        if opt.iprofilecalc:
            writers.write_profiles(opt, opt.outname, res.props, ng,
                                   hostid=res.hostid)
        if res.so_offsets is not None:
            writers.write_so_catalog(opt, opt.outname, res.so_offsets,
                                     res.so_indices, pids, ng, ptype=ptype)
        if opt.iextendedoutput:
            # reference WriteExtendedOutput (io.cxx:3826, main.cxx:526)
            writers.write_extended_output(opt, opt.outname, pids, res.pfof,
                                          hostid=res.hostid,
                                          stype=res.stype)
        writers.write_config_info(opt, opt.outname)
        writers.write_sim_info(opt, opt.outname)
        writers.write_unit_info(opt, opt.outname)
        if opt.iwritefof:
            writers.write_fof_grp(opt.outname,
                                  res.pfof if res.pfof3d is None
                                  else res.pfof3d)
    timer.report()
    return res


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device available",
              file=sys.stderr)
        return 2
    opt = C.parse_config_file(args.config)
    opt.fname = args.input
    opt.inputtype = args.inputtype
    opt.num_files = args.num_files
    opt.nsnapread = args.nsnapread
    if args.output:
        opt.outname = args.output
    if args.verbose is not None:
        opt.iverbose = args.verbose
    for key in ("gnsphblocks", "gnstarblocks", "gnbhblocks",
                "ramsessnapname"):
        if getattr(args, key) is not None:
            setattr(opt, key, getattr(args, key))
    if not opt.outname:
        print("No output name given (config Output= or -o), terminating",
              file=sys.stderr)
        return 9
    C.config_check(opt, strict=True)
    res = run(opt, device=args.device)
    print(f"Found {res.ngroups} structures; catalogs written to "
          f"{opt.outname}.*")
    return 0


if __name__ == "__main__":
    sys.exit(main())
