"""The control: the plain reference put in the program's place, on the
snapshot's positions, velocities and masses rounded to bfloat16 (the
nearest precision below the float32 in which the program computes).

It builds a catalog as the program's is shaped -- the field search
(3DFOF, then 6DFOF and the baryon association where the config asks),
ids by size, a flat hierarchy (the reference has no recursion), each
group's quantities and the field halos' spherical overdensities -- so
that ``checks.compare`` can judge it like the program's.  The
comparison has to find it wrong.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from . import catalog, checks, groups


@dataclass
class ControlCatalog:
    pfof: np.ndarray
    ngroups: int
    props: Dict[str, np.ndarray]
    hostid: np.ndarray
    parent: np.ndarray
    hierarchy_level: np.ndarray
    pfof3d: Optional[np.ndarray] = None
    timings: Dict[str, float] = field(default_factory=dict)


def lowered(snap, dtype=torch.bfloat16):
    """The snapshot with positions, velocities and masses rounded to
    ``dtype`` (and back to float32)."""
    low = copy.copy(snap)
    low.pos = torch.remainder(snap.pos.to(dtype).float(), snap.boxsize)
    low.vel = snap.vel.to(dtype).float()
    low.mass = snap.mass.to(dtype).float()
    return low


def build(snap, prm: checks.Params) -> ControlCatalog:
    """The reference's catalog of ``snap`` (already lowered)."""
    pos, vel, mass = snap.pos, snap.vel, snap.mass
    dev = pos.device
    n = pos.shape[0]
    ptype = None if snap.ptype is None else snap.ptype.long()
    # the field search's particles: the dark matter where a baryon search
    # runs, else every particle (no copy of the arrays)
    dmi = None
    dpos, dvel, dmass = pos, vel, mass
    if prm.baryons and ptype is not None:
        dmi = torch.nonzero(ptype == 1).squeeze(1)
        dpos, dvel, dmass = pos[dmi], vel[dmi], mass[dmi]
    g3 = groups.ids_by_size(groups.fof(dpos, prm.b3d, prm.box).certain,
                            prm.halo_min)
    gid_dm = g3
    if prm.run6d:
        big = g3 > 0
        vfac = prm.e["Halo_6D_vel_linking_length_factor"]
        sub = torch.nonzero(big).squeeze(1)
        sv, sl = dvel[sub].double(), g3[sub]
        if prm.adaptive6d:
            # each 3D group's own scale
            vs2 = torch.clamp_min(checks.dispersion2(
                dvel[sub], dmass[sub], sl, int(g3.max()) + 1) * vfac ** 2,
                1e-30)[sl]
        else:
            vs2 = checks.vscale2_6d(dvel, dmass, g3, big, vfac)

        def extra(i, j):
            scale = vs2[i] if prm.adaptive6d else vs2
            return ((sv[i] - sv[j]) ** 2).sum(1) / scale, sl[i] == sl[j]

        p6 = groups.fof(dpos[sub], prm.b3d *
                        prm.e["Halo_6D_linking_length_factor"], prm.box,
                        extra=extra)
        g6 = groups.ids_by_size(p6.certain, prm.halo_min)
        gid_dm = torch.zeros_like(g3)
        gid_dm[sub] = g6
    pfof = gid_dm
    if dmi is not None:
        pfof = torch.zeros(n, dtype=torch.int64, device=dev)
        pfof[dmi] = gid_dm
    # the groups before the baryons join them: the FOF-particle SO's
    pre = pfof.clone() if prm.inclusive in (1, 2) else None
    if prm.baryons and ptype is not None:
        bar = torch.nonzero(ptype != 1).squeeze(1)
        arg = checks.nearest_grouped_dm(
            pos, vel, ptype, pfof, bar, prm.b3d, prm.box,
            prm.e["Halo_velocity_linking_length_factor"])
        pfof[bar] = torch.where(arg >= 0, pfof[torch.clamp_min(arg, 0)], 0)
    ng = int(pfof.max()) if n else 0
    q = catalog.group_quantities(
        pos, vel, mass, pfof, ng, prm.box,
        ptype=ptype if ptype is not None and bool((ptype != 1).any())
        else None, iterate_cm=prm.iterate_cm)
    props = {"num": q["num"], "gmass": q["mass"], "gcm": q["cm"],
             "gcmvel": q["cmvel"], "gsize": q["size"]}
    for k in ("M_gas", "M_star"):
        if k in q:
            props[k] = q[k]
    props = {k: v.cpu().numpy() for k, v in props.items()}
    if prm.inclusive in (1, 2, 3) and ng > 0:
        ft = torch.arange(1, ng + 1, device=dev)
        if prm.inclusive == 3:
            M, R = catalog.field_so(
                pos, mass, q, ft, prm.lnthr,
                prm.e["Spherical_overdensity_search_factor"],
                prm.e["Spherical_overdensity_min_halo_factor"],
                prm.halo_min, prm.box)
        else:
            # no unbind: the groups are the pre-unbind ones
            M, R = catalog.fof_so(
                pos, mass, pre, ft, prm.lnthr,
                prm.e["Spherical_overdensity_min_halo_factor"],
                prm.min_size, prm.box)
        M, R = M.cpu().numpy(), R.cpu().numpy()
        for j, (mk, rk) in enumerate(checks._SO):
            props[mk] = np.concatenate([[0.0], M[:, j]])
            props[rk] = np.concatenate([[0.0], R[:, j]])
        props["SO_mass"] = np.concatenate(
            [np.zeros((1, M.shape[1] - 5)), M[:, 5:]])
        props["SO_radius"] = np.concatenate(
            [np.zeros((1, R.shape[1] - 5)), R[:, 5:]])
    return ControlCatalog(
        pfof=pfof.cpu().numpy(), ngroups=ng, props=props,
        hostid=np.full(ng + 1, -1, np.int64),
        parent=np.zeros(ng + 1, np.int64),
        hierarchy_level=np.zeros(ng + 1, np.int64),
        pfof3d=g3.cpu().numpy() if prm.run6d else None)
