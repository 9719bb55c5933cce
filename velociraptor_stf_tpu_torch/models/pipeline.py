"""The pipeline (port of velociraptor_stf_tpu/models/pipeline.py).

``search_and_unbind`` runs the stages that ``bench.py`` times: the
cosmology set-up, the 3DFOF/6DFOF field search, the iKeepFOF envelope split
and, with ``iBoundHalos >= 1``, the field-halo unbind, timed as "fof" and
"unbind" as the reference does.  ``find_structures`` runs them, then the
iKeepFOF hierarchy, the property stage on the tagged particles
("properties") and the spherical overdensities of ``Inclusive_halo_masses``
("so"), and returns a catalog in numpy as the reference's does.
Substructure, baryons, per-type properties, single-halo mode and a device
mesh are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from . import halos, properties as props_mod, unbind
from ..ops import so as so_ops

from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.utils import units


@dataclass
class SearchResult:
    pfof: torch.Tensor                  # final group id per particle
    ngroups: int
    W: Optional[torch.Tensor] = None    # potential energies (if unbound)
    pfof3d: Optional[torch.Tensor] = None   # 3DFOF ids when 6D ran
    timings: Dict[str, float] = field(default_factory=dict)
    # iKeepFOF: ids 1..num3dfof are 3DFOF envelopes, parent3d[gid] the
    # envelope of search id gid (before the unbind renumbered the halos)
    num3dfof: int = 0
    parent3d: Optional[torch.Tensor] = None
    gid_map: Optional[torch.Tensor] = None  # unbind's old -> new halo id
    # halo ids before the unbind, kept for Inclusive_halo_masses 1 and 2
    pfof_fof: Optional[torch.Tensor] = None
    ngroups_fof: int = 0


def _clock(device: torch.device):
    """A stage clock: host seconds, read after the card has finished."""
    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()
    return clock


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def search_and_unbind(opt: C.Options, pos, vel, mass,
                      boxsize: Optional[float] = None,
                      device: Union[str, torch.device] = "cuda",
                      ptype=None, mesh=None) -> SearchResult:
    """Field search [+ field unbind] of (N, 3) positions and velocities and
    (N,) masses (numpy or tensors; computed in float32 on ``device``).
    ``boxsize > 0`` makes the box periodic."""
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet")
    if opt.iSingleHalo:
        raise NotImplementedError("iSingleHalo is not ported yet")
    if opt.iSubSearch:
        raise NotImplementedError("substructure search (iSubSearch) is not "
                                  "ported yet")
    if ptype is not None and opt.iBaryonSearch > 0:
        types = np.unique(np.asarray(ptype))
        if C.DARKTYPE in types and len(types) > 1:
            raise NotImplementedError("baryon mode is not ported yet")
    device = torch.device(device)
    clock = _clock(device)
    timings: Dict[str, float] = {}
    units.calc_cosmo_params(opt, opt.a)
    pos, vel, mass = (_as_f32(a, device) for a in (pos, vel, mass))

    t0 = clock()
    fres = halos.search_full_set(opt, pos, vel, mass, boxsize=boxsize)
    pfof, ng = fres.pfof, fres.ngroups
    timings["fof"] = clock() - t0
    pfof3d = fres.pfof3d

    # iKeepFOF: the 3DFOF envelopes are split off (never unbound) and
    # re-attached as ids 1..keepfof afterwards
    keepfof, parent3d = fres.num3dfof, fres.parent3d
    del fres
    env_pfof = None
    if keepfof > 0:
        env_pfof = torch.where(pfof <= keepfof, pfof, 0)
        pfof = torch.where(pfof > keepfof, pfof - keepfof, 0)
        ng -= keepfof

    pfof_fof, ng_fof = (pfof, ng) if opt.iInclusiveHalo in (1, 2) else \
        (None, 0)
    W = gid_map = None
    if opt.uinfo.unbindflag and ng > 0 and opt.iBoundHalos >= 1:
        t0 = clock()
        minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
        ures = unbind.check_unbound_groups(pos, vel, mass, pfof, ng,
                                           opt.uinfo, opt.G, boxsize=boxsize,
                                           min_size=minsize)
        pfof, ng, W = ures.pfof, ures.ngroups, ures.W
        gid_map = ures.gid_map
        timings["unbind"] = clock() - t0

    if keepfof > 0:
        pfof = torch.where(pfof > 0, pfof + keepfof, env_pfof)
        ng += keepfof
    return SearchResult(pfof=pfof, ngroups=ng, W=W, pfof3d=pfof3d,
                        timings=timings, num3dfof=keepfof,
                        parent3d=parent3d, gid_map=gid_map,
                        pfof_fof=pfof_fof, ngroups_fof=ng_fof)


@dataclass
class CatalogResult:
    pfof: np.ndarray           # final group id per particle (original order)
    ngroups: int
    props: Dict[str, np.ndarray]
    W: Optional[np.ndarray] = None       # potential energies
    pfof3d: Optional[np.ndarray] = None  # parent 3DFOF ids when 6D ran
    timings: Dict[str, float] = field(default_factory=dict)
    hostid: Optional[np.ndarray] = None  # top host per group (-1 = field)
    parent: Optional[np.ndarray] = None  # direct parent gid (0 = field)
    hierarchy_level: Optional[np.ndarray] = None
    # SO particle lists (Spherical_overdensity_halo_particle_list_output):
    # CSR over groups 1..ngroups of original particle indices
    so_offsets: Optional[np.ndarray] = None
    so_indices: Optional[np.ndarray] = None
    # structure types (iKeepFOF: FOF3DTYPE envelopes)
    stype: Optional[np.ndarray] = None


def _map_gids(gid_map: np.ndarray, ids, absent):
    """Old -> new gid lookup: ids outside (0, len(gid_map)) map to
    ``absent``."""
    ids = np.asarray(ids)
    ok = (ids > 0) & (ids < len(gid_map))
    return np.where(ok, gid_map[np.clip(ids, 0, len(gid_map) - 1)], absent)


def _remap_hierarchy(gid_map: np.ndarray, ng_new: int, hostid, parent,
                     level):
    """Re-index per-group hierarchy arrays through an old -> new gid map."""
    gid_map = np.asarray(gid_map)
    new_host = np.full(ng_new + 1, -1, np.int64)
    new_parent = np.zeros(ng_new + 1, np.int64)
    new_level = np.zeros(ng_new + 1, np.int32)
    old = np.arange(1, len(parent))
    newg = _map_gids(gid_map, old, 0)
    keep = (newg > 0) & (newg <= ng_new)
    old, newg = old[keep], newg[keep]
    new_parent[newg] = _map_gids(gid_map, parent[old], 0)
    if hostid is not None:
        new_host[newg] = _map_gids(gid_map, hostid[old], -1)
    if level is not None:
        new_level[newg] = level[old]
    return new_host, new_parent, new_level


def _keepfof_hierarchy(keepfof: int, ng: int, parent3d: np.ndarray,
                       gid_map: Optional[np.ndarray]):
    """(hostid, parent, level, stype) of a catalog of ``keepfof``
    envelopes followed by ``ng`` halos (reference pipeline.py:316-353):
    each surviving halo's parent is its envelope, at level 1."""
    gm = gid_map if gid_map is not None else np.arange(ng + 1)
    ng_final = keepfof + ng
    parent = np.zeros(ng_final + 1, np.int64)
    hostid = np.full(ng_final + 1, -1, np.int64)
    level = np.zeros(ng_final + 1, np.int32)
    old6 = np.arange(1, len(parent3d) - keepfof)
    newid = _map_gids(gm, old6, 0)
    sel6 = (newid > 0) & (newid <= ng)
    env = parent3d[keepfof + old6[sel6]]
    dest = keepfof + newid[sel6]
    parent[dest] = env
    hostid[dest] = np.where(env > 0, env, -1)
    level[dest] = 1
    stype = np.full(ng_final + 1, C.HALOSTYPE, np.int32)
    stype[1:keepfof + 1] = C.FOF3DTYPE
    stype[keepfof + 1:] = C.HALOSTYPE + 10 * np.maximum(
        level[keepfof + 1:] - 1, 0)
    return hostid, parent, level, stype


def _tagged_by_group(pfof: torch.Tensor) -> torch.Tensor:
    """Indices of the tagged particles, sorted stably by group."""
    idx = torch.nonzero(pfof > 0).squeeze(1)
    return idx[torch.argsort(pfof[idx], stable=True)]


def find_structures(opt: C.Options, pos, vel, mass,
                    boxsize: Optional[float] = None, ptype=None,
                    extras: Optional[Dict] = None, mesh=None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> CatalogResult:
    """Field search [+ field unbind] + properties [+ SO] of (N, 3)
    positions and velocities and (N,) masses, computed in float32 on
    ``device``: the reference's ``main()`` path for the modes ported so far
    (reference main.cxx:20-544).  Returns numpy arrays."""
    if ptype is not None and len(np.unique(np.asarray(ptype))) > 1:
        raise NotImplementedError("per-type (baryon) properties are not "
                                  "ported yet")
    device = torch.device(device)
    clock = _clock(device)
    pos, vel, mass = (_as_f32(a, device) for a in (pos, vel, mass))
    sres = search_and_unbind(opt, pos, vel, mass, boxsize=boxsize,
                             device=device, ptype=ptype, mesh=mesh)
    timings = dict(sres.timings)
    pfof, ng, W = sres.pfof, sres.ngroups, sres.W
    gid_map = None if sres.gid_map is None else sres.gid_map.cpu().numpy()

    hostid = parent = level = stype = None
    keepfof = sres.num3dfof
    if keepfof > 0:
        hostid, parent, level, stype = _keepfof_hierarchy(
            keepfof, ng - keepfof, sres.parent3d.cpu().numpy(), gid_map)

    # the property stage runs on the tagged particles, group by group
    t0 = clock()
    sub = _tagged_by_group(pfof)
    pr = props_mod.property_bundle(
        opt, pos[sub], vel[sub], mass[sub], pfof[sub], ng,
        W=None if W is None else W[sub], boxsize=boxsize)
    timings["properties"] = clock() - t0
    props_np = {k: v.cpu().numpy()[:ng + 1] for k, v in pr.items()}
    del pr, sub

    so_offsets = so_indices = None
    if opt.iInclusiveHalo > 0 and ng > 0:
        t0 = clock()
        so_offsets, so_indices = _so_stage(
            opt, pos, vel, mass, props_np, ng, hostid, boxsize,
            pfof_fof=sres.pfof_fof, ng_fof=sres.ngroups_fof,
            gid_map=gid_map)
        timings["so"] = clock() - t0

    return CatalogResult(
        pfof=pfof.to(torch.int32).cpu().numpy(), ngroups=ng,
        props=props_np, W=None if W is None else W.cpu().numpy(),
        pfof3d=None if sres.pfof3d is None else
        sres.pfof3d.to(torch.int32).cpu().numpy(),
        timings=timings, hostid=hostid, parent=parent,
        hierarchy_level=level, so_offsets=so_offsets, so_indices=so_indices,
        stype=stype)


_SO_KEYS = ("gMvir", "gRvir", "gM200c", "gR200c", "gM200m", "gR200m",
            "gM500c", "gR500c", "gMBN98", "gRBN98")


def _so_stage(opt: C.Options, pos, vel, mass, props_np, ng: int, hostid,
              boxsize, *, pfof_fof=None, ng_fof: int = 0, gid_map=None):
    """Inclusive / all-particle spherical overdensities of the field halos
    (``Inclusive_halo_masses``, reference allvars.h:520): 1 and 2 take the
    SO of each halo's pre-unbind FOF particles (GetInclusiveMasses,
    substructureproperties.cxx:1946), 3 that of all particles in the
    search sphere (GetSOMasses, :2731).  Member-only values stay as
    ``*_excl``.  Returns the CSR SO particle lists when
    ``Spherical_overdensity_halo_particle_list_output`` is set."""
    for k in _SO_KEYS + ("SO_mass", "SO_radius"):
        if k in props_np:
            props_np[k + "_excl"] = props_np[k]
            props_np[k] = np.array(props_np[k])
    field_sel = np.arange(1, ng + 1)
    if hostid is not None:
        field_sel = field_sel[np.asarray(hostid[1:ng + 1]) == -1]
    if len(field_sel) == 0:
        return None, None

    so_offsets = so_indices = None
    lnthr = [
        math.log(max(opt.virlevel * opt.rhobg, 1e-30)),
        math.log(opt.rhocrit * 200.0),
        math.log(opt.rhobg * 200.0),
        math.log(opt.rhocrit * 500.0),
        math.log(opt.virBN98 * opt.rhocrit),
    ] + [math.log(opt.rhocrit * t) for t in opt.SOthresholds_values_crit]
    key_of = list(zip(_SO_KEYS[::2], _SO_KEYS[1::2]))

    if opt.iInclusiveHalo == 3:
        num = props_np["num"][field_sel]
        centers = props_np["gcm"][field_sel]
        rsearch = so_ops.so_search_radii(
            props_np["gmass"][field_sel], props_np["gsize"][field_sel],
            min(lnthr) - math.log(2.0), opt.SphericalOverdensitySeachFac)
        minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
        minnum = np.maximum(
            (opt.SphericalOverdensityMinHaloFac * num + 1).astype(np.int32),
            int(minsize * opt.SphericalOverdensityMinHaloFac + 1))
        mmin = float(mass.min())
        M, R = so_ops.so_masses_all_particles(
            pos, mass, centers, rsearch, lnthr, boxsize=boxsize,
            minnum=minnum, first_mass=np.full(len(field_sel), mmin))
        for i, (mk, rk) in enumerate(key_of):
            props_np[mk][field_sel] = M[:, i]
            props_np[rk][field_sel] = R[:, i]
        for i in range(len(opt.SOthresholds_values_crit)):
            props_np["SO_mass"][field_sel, i] = M[:, 5 + i]
            props_np["SO_radius"][field_sel, i] = R[:, 5 + i]
        if opt.iSphericalOverdensityPartList:
            offs_f, idx = so_ops.so_particle_list(
                pos, centers, np.maximum(R.max(axis=1), 1e-10),
                boxsize=boxsize)
            # group g holds so_indices[so_offsets[g-1]:so_offsets[g]];
            # field_sel ascends, so the halos' lists concatenate in order
            counts = np.zeros(ng + 1, np.int64)
            counts[field_sel] = np.diff(offs_f)
            so_offsets = np.concatenate([[0], np.cumsum(counts[1:])])
            so_indices = np.asarray(idx, np.int64)
    elif pfof_fof is not None and ng_fof > 0:
        # member-only SO on the pre-unbind labels
        sub = _tagged_by_group(pfof_fof)
        pr_fof = props_mod.compute_properties(
            pos[sub], vel[sub], mass[sub], pfof_fof[sub], ng_fof, G=opt.G,
            boxsize=boxsize, rhocrit=opt.rhocrit, rhobg=opt.rhobg,
            virlevel=opt.virlevel if opt.virlevel > 0 else 200.0,
            virBN98=opt.virBN98,
            so_thresholds=tuple(opt.SOthresholds_values_crit),
            min_size=opt.MinSize, calc_shape=False)
        gm = gid_map[:ng_fof + 1] if gid_map is not None \
            else np.arange(ng_fof + 1)
        # old FOF gid -> final gid, surviving field halos only
        fieldmask = np.zeros(ng + 1, bool)
        fieldmask[field_sel] = True
        old = np.arange(1, ng_fof + 1)
        new = gm[1:ng_fof + 1]
        sel = (new > 0) & (new <= ng) & fieldmask[np.clip(new, 0, ng)]
        old, new = old[sel], new[sel]
        for k in _SO_KEYS:
            props_np[k][new] = pr_fof[k].cpu().numpy()[old]
        if props_np["SO_mass"].shape[-1] > 0:
            props_np["SO_mass"][new] = pr_fof["SO_mass"].cpu().numpy()[old]
            props_np["SO_radius"][new] = \
                pr_fof["SO_radius"].cpu().numpy()[old]
    return so_offsets, so_indices
