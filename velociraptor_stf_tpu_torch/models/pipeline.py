"""The pipeline (port of velociraptor_stf_tpu/models/pipeline.py).

``search_and_unbind`` runs the stages that ``bench.py`` times: the
cosmology set-up, the 3DFOF/6DFOF field search, the iKeepFOF envelope split
and, with ``iBoundHalos >= 1``, the field-halo unbind, timed as "fof" and
"unbind" as the reference does.  ``find_structures`` runs them, then the
iKeepFOF hierarchy, the property stage on the tagged particles
("properties") and the spherical overdensities of ``Inclusive_halo_masses``
("so"), and returns a catalog in numpy as the reference's does.  With
``iSubSearch`` both run the substructure recursion after the field unbind
("substructure", ``models/substructure.py``), and with ``iBoundHalos = 2``
the field halos are unbound again once their substructures are carved out.
Given particle types, both run the baryon association and the combined
unbind after the dark-matter search ("baryons"), and ``find_structures``
adds the per-type properties.  ``iSingleHalo`` takes the whole input as
group 1.

With ``mesh`` (``parallel/mesh.py``) both run sharded over the mesh's
shards: the slab FOF with ghost exchange, the whole-groups unbind, the
sharded recursion and baryon association, the whole-groups property stage
and the psum'd SO histograms (``parallel/``), and return the catalog of
the single-device run.  Whole arrays then live on ``mesh.home``, and the
host sees scalars, per-group tables and, once, the catalog's
per-particle payloads (``utils/transfer.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from . import baryons as baryons_mod
from . import halos, haloprops, properties as props_mod, substructure, unbind
from ..ops import so as so_ops
from ..utils import config as C
from ..utils import units
from ..utils.timing import span
from ..utils.transfer import fetch_bulk, fetch_small, stage_in


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
    # substructure hierarchy per group id (numpy; None without iSubSearch)
    hostid: Optional[np.ndarray] = None
    parent: Optional[np.ndarray] = None
    level: Optional[np.ndarray] = None


def _as_f32(x, device: torch.device) -> torch.Tensor:
    return stage_in(x, device, torch.float32)


def _as_ptype(ptype, device: torch.device) -> Optional[torch.Tensor]:
    """Particle types as an int64 tensor on ``device`` (None stays None):
    they cross at the caller's width and are widened there."""
    return None if ptype is None else stage_in(ptype, device, torch.int64)


def _scatter(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) zeros with ``values`` at rows ``idx``."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    out[idx] = values
    return out


def _check_unbound(opt: C.Options, mesh, pos, vel, mass, pfof, ng: int,
                   boxsize, min_size: int) -> unbind.UnbindResult:
    """The unbind over the mesh's shards (whole groups per shard,
    ``parallel/distributed_unbind.py``) or on one device."""
    if mesh is not None:
        from ..parallel.distributed_unbind import distributed_unbind

        return distributed_unbind(pos, vel, mass, pfof, ng, opt.uinfo, opt.G,
                                  mesh, boxsize=boxsize, min_size=min_size)
    return unbind.check_unbound_groups(pos, vel, mass, pfof, ng, opt.uinfo,
                                       opt.G, boxsize=boxsize,
                                       min_size=min_size)


def search_and_unbind(opt: C.Options, pos, vel, mass,
                      boxsize: Optional[float] = None,
                      device: Union[str, torch.device] = "cuda",
                      ptype=None, mesh=None) -> SearchResult:
    """Field search [+ field unbind] [+ baryons] of (N, 3) positions and
    velocities and (N,) masses (numpy or tensors; computed in float32 on
    ``device``).  ``boxsize > 0`` makes the box periodic.

    With ``ptype`` holding dark matter and other types and
    ``Baryon_searchflag > 0`` the search and the field unbind run on the
    dark matter alone; gas, star and black-hole particles then join the
    group of their phase-space-nearest tagged DM particle and the groups
    are unbound once more with them (reference SearchBaryons,
    search.cxx:3053, main.cxx:397), timed as "baryons".  ``pfof3d`` is
    then in the order of the dark matter subset, as in the reference.
    With ``mesh`` every stage runs over its shards, the inputs and
    results on ``mesh.home`` (``device`` is then not read); the field
    search shards a periodic box only, as in the JAX package."""
    device = torch.device(device) if mesh is None else mesh.home
    timings: Dict[str, float] = {}
    units.calc_cosmo_params(opt, opt.a)
    pos, vel, mass = (_as_f32(a, device) for a in (pos, vel, mass))
    n = pos.shape[0]
    dmi = bi = None
    if ptype is not None and opt.iBaryonSearch > 0:
        isdm = _as_ptype(ptype, device) == C.DARKTYPE
        ndm = int(isdm.sum())
        if 0 < ndm < n:
            dmi = torch.nonzero(isdm).squeeze(1)
            bi = torch.nonzero(~isdm).squeeze(1)
    spos, svel, smass = (pos, vel, mass) if dmi is None else \
        (pos[dmi], vel[dmi], mass[dmi])

    if opt.iSingleHalo:
        # the input is one halo: no field search, the whole set is group 1
        # (reference main.cxx:285), its linking lengths optionally scaled
        # from its bulk properties (ScaleLinkingLengths, main.cxx:333)
        with span("halos.fof", timings, "fof", device=device):
            if opt.iScaleLengths:
                haloprops.scale_linking_lengths(
                    opt, spos.cpu().numpy(), svel.cpu().numpy(),
                    smass.cpu().numpy())
            pfof = torch.ones(spos.shape[0], dtype=torch.int64,
                              device=device)
        ng, pfof3d, keepfof, parent3d = 1, None, 0, None
    else:
        with span("halos.fof", timings, "fof", device=device):
            if mesh is not None and boxsize:
                fres = halos.search_full_set_sharded(opt, spos, svel, smass,
                                                     boxsize, mesh)
            else:
                fres = halos.search_full_set(opt, spos, svel, smass,
                                             boxsize=boxsize)
        pfof, ng = fres.pfof, fres.ngroups
        pfof3d = fres.pfof3d
        # iKeepFOF: the 3DFOF envelopes are split off (never unbound) and
        # re-attached as ids 1..keepfof afterwards
        keepfof, parent3d = fres.num3dfof, fres.parent3d
        del fres
    if keepfof > 0 and dmi is not None:
        # the reference's envelope re-attachment mixes DM-subset and
        # full-set arrays and fails on this combination
        raise NotImplementedError("3DFOF envelopes (iKeepFOF) with a baryon "
                                  "search are not supported")
    env_pfof = None
    if keepfof > 0:
        env_pfof = torch.where(pfof <= keepfof, pfof, 0)
        pfof = torch.where(pfof > keepfof, pfof - keepfof, 0)
        ng -= keepfof

    pfof_fof, ng_fof = (pfof, ng) if opt.iInclusiveHalo in (1, 2) else \
        (None, 0)
    W = gid_map = None
    if opt.uinfo.unbindflag and ng > 0 and opt.iBoundHalos >= 1:
        with span("unbind", timings, "unbind", device=device):
            minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else \
                opt.MinSize
            ures = _check_unbound(opt, mesh, spos, svel, smass, pfof, ng,
                                  boxsize, minsize)
            pfof, ng, W = ures.pfof, ures.ngroups, ures.W
            gid_map = ures.gid_map

    hostid = parent = level = None
    if opt.iSubSearch and ng > 0:
        with span("substructure", timings, "substructure", device=device):
            pfof, ng, hostid, parent, level = substructure.search_sub_sub(
                opt, spos, svel, smass, pfof, ng, boxsize=boxsize,
                timings=timings, mesh=mesh)
        if opt.iBoundHalos > 1 and opt.uinfo.unbindflag and ng > 0 and \
                dmi is None:
            with span("unbind", timings, "unbind", device=device):
                pfof, ng, W, hostid, parent, level = _reunbind_halos(
                    opt, spos, svel, smass, pfof, ng, W, hostid, parent,
                    level, boxsize, mesh)

    if dmi is not None:
        with span("baryons", timings, "baryons", device=device):
            grp_b = baryons_mod.search_baryons(opt, spos, svel, pfof, pos[bi],
                                               vel[bi], boxsize=boxsize,
                                               mesh=mesh)
            # DM and baryon labels spliced into full-set order
            pfof = _scatter(pfof, dmi, n)
            pfof[bi] = grp_b.long()
            if W is not None:
                # the field unbind's potentials live on the DM subset; the
                # combined pass overwrites them unless every group dissolved
                W = _scatter(W, dmi, n)
            # so do the pre-unbind labels for the inclusive masses: baryons
            # are untagged there
            if pfof_fof is not None:
                pfof_fof = _scatter(pfof_fof, dmi, n)
            # the groups are unbound again with their baryons (reference
            # search.cxx:3500+), down to MinSize, not HaloMinSize
            if opt.uinfo.unbindflag and ng > 0:
                ures = _check_unbound(opt, mesh, pos, vel, mass, pfof, ng,
                                      boxsize, opt.MinSize)
                pfof, W = ures.pfof, ures.W
                if parent is not None:
                    hostid, parent, level = _remap_hierarchy(
                        ures.gid_map.cpu().numpy(), ures.ngroups, hostid,
                        parent, level)
                ng = ures.ngroups
                # old FOF id -> final id through both renumberings (field
                # halo ids pass the substructure splice unchanged)
                gm = ures.gid_map
                gid_map = gm if gid_map is None else \
                    gm[torch.clamp(gid_map, 0, gm.shape[0] - 1)]

    if keepfof > 0:
        pfof = torch.where(pfof > 0, pfof + keepfof, env_pfof)
        ng += keepfof
    return SearchResult(pfof=pfof, ngroups=ng, W=W, pfof3d=pfof3d,
                        timings=timings, num3dfof=keepfof,
                        parent3d=parent3d, gid_map=gid_map,
                        pfof_fof=pfof_fof, ngroups_fof=ng_fof,
                        hostid=hostid, parent=parent, level=level)


def _reunbind_halos(opt: C.Options, pos, vel, mass, pfof, ng: int, W,
                    hostid, parent, level, boxsize, mesh=None):
    """``Bound_halos = 2``: the field halos, with their substructures
    carved out, are unbound again (reference search.cxx:2841); surviving
    halos become 1..ng_h by size, the substructures follow in their
    order, and the hierarchy and potentials follow them."""
    dev = pfof.device
    is_halo = parent[:ng + 1] == 0
    halo_of_p = (pfof > 0) & torch.from_numpy(is_halo).to(dev)[pfof]
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    ures = _check_unbound(opt, mesh, pos, vel, mass,
                          torch.where(halo_of_p, pfof, 0), ng, boxsize,
                          minsize)
    gm_h = ures.gid_map[:ng + 1]
    gm_np = gm_h.cpu().numpy()
    remap = np.zeros(ng + 1, np.int64)
    remap[is_halo] = gm_np[is_halo]
    sub_ids = np.nonzero(~is_halo[1:])[0] + 1
    remap[sub_ids] = ures.ngroups + 1 + np.arange(len(sub_ids))
    pfof_new = torch.where(halo_of_p, gm_h[pfof] * ures.bound,
                           torch.from_numpy(remap).to(dev)[pfof])
    ng_new = ures.ngroups + len(sub_ids)
    new_parent = np.zeros(ng_new + 1, np.int64)
    new_host = np.full(ng_new + 1, -1, np.int64)
    new_level = np.zeros(ng_new + 1, np.int32)
    olds = np.arange(1, ng + 1)
    newg = remap[olds]
    keep = newg > 0
    olds, newg = olds[keep], newg[keep]
    new_parent[newg] = _map_gids(remap, parent[olds], 0)
    hv = _map_gids(remap, hostid[olds], 0)
    new_host[newg] = np.where(hv > 0, hv, -1)
    new_level[newg] = level[olds]
    if W is not None:
        W = torch.where(halo_of_p, ures.W, W)
    return pfof_new, ng_new, W, new_host, new_parent, new_level


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
                       gid_map: Optional[np.ndarray], sub_host=None,
                       sub_parent=None, sub_level=None):
    """(hostid, parent, level, stype) of a catalog of ``keepfof``
    envelopes followed by ``ng`` halos and substructures (reference
    pipeline.py:316-353): each surviving field halo's parent is its
    envelope, at level 1; a substructure keeps its parent and host,
    shifted past the envelopes, one level deeper."""
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
    if sub_parent is not None:
        g = np.arange(1, len(sub_parent))
        hasp = g[sub_parent[g] > 0]
        parent[keepfof + hasp] = keepfof + sub_parent[hasp]
        level[keepfof + hasp] = sub_level[hasp] + 1
        hash_ = g[sub_host[g] > 0]
        hostid[keepfof + hash_] = keepfof + sub_host[hash_]
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
    """Field search [+ field unbind] [+ baryons] + properties [+ SO] of
    (N, 3) positions and velocities and (N,) masses, computed in float32
    on ``device``: the reference's ``main()`` path for the modes ported so
    far (reference main.cxx:20-544).  ``ptype`` (N,) particle types and
    ``extras`` (hydro fields of ``properties.HYDRO_FIELDS``, each (N,)) feed the
    baryon search, the reference-frame choice and the per-type
    properties, which are computed when several types are present.
    Returns numpy arrays; with no group found, ``ngroups`` 0, ``pfof`` all
    zero and one-row property arrays.  With ``mesh`` the stages run over
    its shards (``search_and_unbind``), the properties with whole groups
    per shard and the all-particle SO from the shards' histograms."""
    device = torch.device(device) if mesh is None else mesh.home
    with span("catalog", particles=int(pos.shape[0])):
        timings: Dict[str, float] = {}
        with span("to_device", timings, "to_device", device=device):
            pos, vel, mass = (_as_f32(a, device) for a in (pos, vel, mass))
            ptype = _as_ptype(ptype, device)
        sres = search_and_unbind(opt, pos, vel, mass, boxsize=boxsize,
                                 device=device, ptype=ptype, mesh=mesh)
        timings.update(sres.timings)
        pfof, ng, W = sres.pfof, sres.ngroups, sres.W
        gid_map = None if sres.gid_map is None else sres.gid_map.cpu().numpy()

        hostid, parent, level, stype = sres.hostid, sres.parent, sres.level, \
            None
        keepfof = sres.num3dfof
        if keepfof > 0:
            hostid, parent, level, stype = _keepfof_hierarchy(
                keepfof, ng - keepfof, sres.parent3d.cpu().numpy(), gid_map,
                hostid, parent, level)

        # the property stage runs on the tagged particles, group by group;
        # with none tagged, on one untagged particle: row 0 alone
        with span("properties", timings, "properties", device=device):
            pertype = ptype is not None and \
                int(torch.unique(ptype).shape[0]) > 1
            # the hydro fields' copy stays here, where they are first needed
            with span("to_device", timings, "to_device", device=device):
                hydro = {k: _as_f32(v, device)
                         for k, v in (extras or {}).items()
                         if k in props_mod.HYDRO_FIELDS and v is not None}
            if mesh is not None and ng > 0:
                from ..parallel.distributed_props import distributed_properties

                props_np = distributed_properties(
                    opt, pos, vel, mass, pfof, ng, mesh, W=W, ptype=ptype,
                    boxsize=boxsize, pertype=pertype, **hydro)
            else:
                sub = _tagged_by_group(pfof)
                if sub.shape[0] == 0:
                    sub = torch.zeros(1, dtype=torch.int64, device=device)
                pr = props_mod.property_bundle(
                    opt, pos[sub], vel[sub], mass[sub], pfof[sub], ng,
                    W=None if W is None else W[sub],
                    ptype=None if ptype is None else ptype[sub],
                    boxsize=boxsize, pertype=pertype,
                    **{k: v[sub] for k, v in hydro.items()})
                props_np = {k: v[:ng + 1] for k, v in fetch_small(pr).items()}
                del pr, sub
        del hydro

        so_offsets = so_indices = None
        if opt.iInclusiveHalo > 0 and ng > 0:
            with span("so", timings, "so", device=device):
                so_offsets, so_indices = _so_stage(
                    opt, pos, vel, mass, props_np, ng, hostid, boxsize,
                    pfof_fof=sres.pfof_fof, ng_fof=sres.ngroups_fof,
                    gid_map=gid_map, mesh=mesh)

        # the catalog's per-particle payloads: the one time they leave the
        # device(s)
        return CatalogResult(
            pfof=fetch_bulk(pfof.to(torch.int32), "catalog_pfof"), ngroups=ng,
            props=props_np,
            W=None if W is None else fetch_bulk(W, "catalog_W"),
            pfof3d=None if sres.pfof3d is None else
            fetch_bulk(sres.pfof3d.to(torch.int32), "pfof3d"),
            timings=timings, hostid=hostid, parent=parent,
            hierarchy_level=level, so_offsets=so_offsets,
            so_indices=so_indices, stype=stype)


_SO_KEYS = ("gMvir", "gRvir", "gM200c", "gR200c", "gM200m", "gR200m",
            "gM500c", "gR500c", "gMBN98", "gRBN98")


def _so_stage(opt: C.Options, pos, vel, mass, props_np, ng: int, hostid,
              boxsize, *, pfof_fof=None, ng_fof: int = 0, gid_map=None,
              mesh=None):
    """Inclusive / all-particle spherical overdensities of the field halos
    (``Inclusive_halo_masses``, reference allvars.h:520): 1 and 2 take the
    SO of each halo's pre-unbind FOF particles (GetInclusiveMasses,
    substructureproperties.cxx:1946), 3 that of all particles in the
    search sphere (GetSOMasses, :2731), from the shards' histograms with a
    ``mesh``.  Member-only values stay as ``*_excl``.  Returns the CSR SO
    particle lists when ``Spherical_overdensity_halo_particle_list_output``
    is set."""
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
        kw = dict(boxsize=boxsize, minnum=minnum,
                  first_mass=np.full(len(field_sel), mmin))
        if mesh is not None:
            from ..parallel.distributed_so import distributed_so_masses

            M, R = distributed_so_masses(pos, mass, centers, rsearch, lnthr,
                                         mesh, **kw)
        else:
            M, R = so_ops.so_masses_all_particles(pos, mass, centers,
                                                  rsearch, lnthr, **kw)
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
