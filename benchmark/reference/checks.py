"""The comparison that decides ``correct``: a candidate catalog (the
program's, or the control's) judged against the plain reference.

Every number is a count or a widest gap; 0 is a perfect catalog.  What
each holds the catalog to:

- ``fof3d_wrong``: particles at which the field 3D search breaks FOF
  (``groups.sandwich_violations``) -- the program's 3D groups are the
  union of each field halo with its substructures, or ``pfof3d`` where
  the search ran on the dark matter alone.
- ``fof6d_wrong`` (6D field searches): dark-matter particles at which
  the structure trees break the configuration's 6D search.
  ``FoF_Field_search_type=4`` (FOF6D): a tree not inside one 6D FOF
  group of the reference (links inside one 3D group of the halo minimum
  size, the largest group's velocity dispersion as the velocity scale).
  ``=3`` (FOF6DADAPTIVE): each of the catalog's 3D groups is linked with
  its own velocity dispersion as the scale (``_fof6d_adaptive``); where
  the trees are the field search's groups (``Params.trees_are_groups``)
  they have to be its whole 6D groups, FOF between the certain and the
  possible links (``groups.sandwich_violations``), else each has to lie
  inside one.  ``fof6d_ambiguous_pairs`` is reported beside it.
- ``hierarchy_wrong``: structures whose parent, level or host break the
  hierarchy's rules, or that hold no member.
- ``props_gap``: the widest relative gap between the catalog's and the
  reference's count, mass and per-type masses of every structure, from
  the catalog's own members.
- ``centre_off_share``: share of structures whose centre (distance over
  the size), its velocity (over its speed, at least 1 km/s) or size is
  off by more than CENTRE_TOL (``centre_gap``, the widest, is reported
  beside it).
- ``so_off_share``: share of the field halos' spherical overdensity
  masses and radii off by more than SO_TOL.  ``Inclusive_halo_masses=3``:
  from all particles around the centre, on 128 log bins
  (``catalog.field_so``).  ``=1`` and ``=2``: from the halo's
  pre-unbind FOF particles alone, member by member
  (``catalog.fof_so``): its structure tree where the trees are the field
  search's groups, else the reference's own group that holds the tree
  (6D where the search is 6D).  ``=0``: not computed.
- ``unbound_share`` (configs that unbind): share of the members of the
  structures the configuration unbinds (every structure after a baryon
  search's combined unbind, or with ``Bound_halos`` >= 1; otherwise the
  substructures) that are not bound in their structure as it stands:
  Allowed_kinetic_potential_ratio x T + W > 0, with W the float64
  direct potential of the structure's own members and T in its centre
  of mass frame.  With ``Keep_background_potential=1`` the program
  keeps the potential of the members a structure started with, so a
  sound catalog reads above 0; with ``=0`` it recomputes the potential
  of the members that stay as others leave, as this number does.
- ``hosts_missed`` (planted subhalos): share of the hosts with planted
  subhalos in which no substructure holds half of any of them: the
  recursion found nothing there.  ``subhalos_missed``, the share of
  planted subhalos that no substructure holds half of, is reported
  beside it: a quarter to a half of these 20-48 particle subhalos are
  missed on sound runs, so a flat catalog's 1.0 is less than three
  times its sound readings.
- ``baryons_wrong`` (baryon search): grouped baryons whose phase-space
  nearest grouped dark-matter particle is not in their structure tree;
  ``baryons_missed``: share of the baryons with such a particle that
  are in no group (the combined unbind removes some).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import catalog, groups
from .pairs import dist2, neighbour_pairs

# a centre or an SO value counts as off beyond these relative gaps; few
# sound values pass them (with Iterate_cm_flag the shrinking sphere's
# last sphere can take or leave a surface particle by rounding; an SO
# crossing in a bin of a few particles moves), a lower precision moves
# most of them
CENTRE_TOL = 1e-2
SO_TOL = 1e-2

# VELOCIraptor's defaults for the keys a config may leave out
DEFAULTS = {
    "Minimum_size": 20, "Minimum_halo_size": -1,
    "Halo_6D_linking_length_factor": 1.0,
    "Halo_6D_vel_linking_length_factor": 1.25,
    "Halo_velocity_linking_length_factor": 1.0,
    "Baryon_searchflag": 0, "Iterate_cm_flag": 1,
    "Inclusive_halo_masses": 0, "Virial_density": -1.0,
    "Spherical_overdensity_search_factor": 2.5,
    "Spherical_overdensity_min_halo_factor": 0.05,
    "Unbind_flag": 0, "Allowed_kinetic_potential_ratio": 1.0,
    "Softening_length": 0.0, "Bound_halos": 0,
    "Search_for_substructure": 0,
    "Physical_linking_length": 0.2, "Halo_linking_length_factor": 1.0,
    "Keep_FOF": 0,
}


class Params:
    """What the comparison reads of a configuration: its ``cfg`` lines
    with VELOCIraptor's defaults, and the linking length from the mean
    spacing of all ``n_total`` particles."""

    def __init__(self, cfg: dict, boxsize: float, n_total: int, a: float):
        e = dict(DEFAULTS)
        extra = []
        for line in cfg["cfg"]:
            k, v = line.split("=", 1)
            if k == "Overdensity_values_in_critical_density":
                extra = [float(x) for x in v.split(",") if x]
                continue
            try:
                e[k] = float(v.rstrip(","))
            except ValueError:
                pass
        self.e = e
        self.box = float(boxsize)
        self.a = float(a)
        # the field's linking length over the mean spacing:
        # Halo_3D_linking_length where given, else
        # Halo_linking_length_factor x Physical_linking_length
        ell = e.get("Halo_3D_linking_length", -1.0)
        if ell <= 0:
            ell = e["Halo_linking_length_factor"] * \
                e["Physical_linking_length"]
        self.b3d = ell * boxsize / n_total ** (1 / 3)
        self.min_size = int(e["Minimum_size"])
        hm = int(e["Minimum_halo_size"])
        self.halo_min = hm if hm > 0 else self.min_size
        self.run6d = int(e["FoF_Field_search_type"]) in (3, 4)
        # FOF6DADAPTIVE: each 3D group's own velocity scale (type 4,
        # FOF6D: the largest group's for all)
        self.adaptive6d = int(e["FoF_Field_search_type"]) == 3
        self.baryons = int(e["Baryon_searchflag"]) > 0
        self.iterate_cm = bool(e["Iterate_cm_flag"])
        self.lnthr = catalog.so_thresholds(e, sorted(extra), self.a)
        self.inclusive = int(e["Inclusive_halo_masses"])
        # the catalog's structure trees are exactly the field search's
        # groups: no unbind of the field halos, no baryons added, no 3DFOF
        # envelopes, and the recursion's unbind hands what it drops from a
        # candidate back to the structure searched (its splice moves only
        # the candidates' own members: models/substructure.py)
        self.trees_are_groups = int(e["Bound_halos"]) == 0 and \
            not self.baryons and int(e["Keep_FOF"]) == 0
        self.G = e["Gravity"]
        self.eratio = e["Allowed_kinetic_potential_ratio"]
        self.eps = e["Softening_length"]
        unbind = int(e["Unbind_flag"]) > 0
        # which structures the program unbinds: all of them in a baryon
        # search's combined unbind or with Bound_halos; else the
        # recursion's candidates
        self.unbind_all = unbind and (self.baryons or
                                      int(e["Bound_halos"]) >= 1)
        self.unbind_subs = unbind and int(e["Search_for_substructure"]) > 0


def tops(hostid: np.ndarray, ng: int) -> np.ndarray:
    """(ng + 1,) the top of each structure's tree: its host, or itself
    where it has none."""
    g = np.arange(ng + 1)
    h = np.asarray(hostid[:ng + 1], np.int64)
    return np.where(h > 0, h, g)


def hierarchy_wrong(pfof: np.ndarray, ng: int, hostid, parent, level,
                    orphans: bool) -> int:
    """Structures that break the hierarchy (the port's own rules, as a
    count): parent out of range or itself, level not the parent's + 1
    (0 in the field), hostid not the top ancestor (-1 in the field; an
    orphan of the baryons' unbind keeps its level with parent 0 and a
    field host or 0), a cycle, or no members.  (A structure may hold
    fewer than Minimum_size once its own substructures are carved out.)"""
    g = np.arange(1, ng + 1)
    num = np.bincount(pfof, minlength=ng + 1)[:ng + 1]
    bad = num[1:] < 1
    if parent is None:
        return int(bad.sum())
    parent = np.asarray(parent, np.int64)[:ng + 1]
    host = np.asarray(hostid, np.int64)[:ng + 1]
    level = np.asarray(level, np.int64)[:ng + 1]
    if not (len(parent) == len(host) == len(level) == ng + 1):
        return ng
    p = parent[1:]
    bad |= (p < 0) | (p > ng) | (p == g)
    pc = np.clip(p, 0, ng)
    orphan = np.zeros(ng + 1, bool)
    if orphans:
        orphan[1:] = (p == 0) & (level[1:] > 0)
    want_level = np.where(p > 0, level[pc] + 1, 0)
    bad |= (level[1:] != want_level) & ~orphan[1:]
    top = g.copy()
    for _ in range(int(level.max(initial=0)) + 2):
        nxt = parent[np.clip(top, 0, ng)]
        top = np.where((nxt > 0) & (nxt <= ng), nxt, top)
    bad |= parent[top] > 0
    oh = host[1:]
    ohc = np.clip(oh, 0, ng)
    bad |= orphan[1:] & (oh != 0) & ((oh < 0) | (oh > ng) | (parent[ohc] > 0)
                                     | (level[ohc] > 0))
    want_host = np.where(orphan[top], host[top], np.where(top == g, -1, top))
    bad |= (host[1:] != want_host)
    return int(bad.sum())


def _rel(a: torch.Tensor, b: torch.Tensor, floor) -> torch.Tensor:
    return (a.double() - b.double()).abs() / torch.clamp_min(
        b.double().abs(), floor)


def _column(cand_props, key: str, ng: int, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(cand_props[key])[1:ng + 1],
                           device=dev).double()


def props_gap(cand_props: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor],
              ng: int, mpart: float) -> float:
    """Widest relative gap of the count, mass and per-type masses over
    structures 1..ng."""
    if ng == 0:
        return 0.0
    dev = ref["mass"].device
    gaps = [_rel(_column(cand_props, "num", ng, dev), ref["num"][1:], 1.0),
            _rel(_column(cand_props, "gmass", ng, dev), ref["mass"][1:],
                 mpart)]
    for k in ("M_gas", "M_star"):
        if k in ref and k in cand_props:
            gaps.append(_rel(_column(cand_props, k, ng, dev), ref[k][1:],
                             mpart))
    return max(float(g.max()) for g in gaps)


def centre_gaps(cand_props, ref, ng: int, box: float) -> torch.Tensor:
    """Per structure, the worst relative gap of its centre (distance over
    the size), centre velocity (over its speed, at least 1 km/s) and
    size."""
    dev = ref["mass"].device
    size = torch.clamp_min(ref["size"][1:], 1e-12)
    d = _column(cand_props, "gcm", ng, dev) - ref["cm"][1:]
    d = d - box * torch.round(d / box)
    dv = (_column(cand_props, "gcmvel", ng, dev) - ref["cmvel"][1:]).norm(
        dim=1) / torch.clamp_min(ref["cmvel"][1:].norm(dim=1), 1.0)
    return torch.maximum(torch.maximum(d.norm(dim=1) / size, dv), _rel(
        _column(cand_props, "gsize", ng, dev), ref["size"][1:], 1e-12))


_SO = (("gMvir", "gRvir"), ("gM200c", "gR200c"), ("gM200m", "gR200m"),
       ("gM500c", "gR500c"), ("gMBN98", "gRBN98"))


def so_off_share(cand_props, M, R, field: np.ndarray) -> float:
    """Share of the field halos' SO masses and radii (every threshold)
    whose relative gap exceeds SO_TOL, a value found on one side only
    counting as off."""
    if len(field) == 0:
        return 0.0
    cols_m = [np.asarray(cand_props[m])[field] for m, _ in _SO]
    cols_r = [np.asarray(cand_props[r])[field] for _, r in _SO]
    if "SO_mass" in cand_props and np.asarray(cand_props["SO_mass"]).ndim == 2:
        som = np.asarray(cand_props["SO_mass"])[field]
        sor = np.asarray(cand_props["SO_radius"])[field]
        cols_m += [som[:, i] for i in range(som.shape[1])]
        cols_r += [sor[:, i] for i in range(sor.shape[1])]
    cm = np.stack(cols_m, 1).astype(np.float64)
    cr = np.stack(cols_r, 1).astype(np.float64)
    rm, rr = M.cpu().numpy(), R.cpu().numpy()
    off = 0
    for c, r in ((cm, rm), (cr, rr)):
        both = (c > 0) & (r > 0)
        gap = np.abs(c - r) / np.where(both, r, 1.0)
        off += int((((c > 0) != (r > 0)) | (both & (gap > SO_TOL))).sum())
    return off / (2.0 * cm.size)


def direct_potential(pos, mass, gid: torch.Tensor, G: float, eps: float,
                     box: float, budget: Optional[int] = None
                     ) -> torch.Tensor:
    """float64 potential energy m_i sum_j -G m_j / sqrt(r_ij^2 + eps^2)
    of every particle over the other members of its group (``gid`` > 0;
    minimum image), by direct summation in tiles of at most ``budget``
    pairs."""
    dev = pos.device
    n = pos.shape[0]
    W = torch.zeros(n, dtype=torch.float64, device=dev)
    sel = torch.nonzero(gid > 0).squeeze(1)
    if sel.numel() == 0:
        return W
    budget = budget or ((1 << 24) if dev.type == "cuda" else (1 << 20))
    order = sel[torch.argsort(gid[sel], stable=True)]
    p, m = pos[order].double(), mass[order].double()
    _, counts = torch.unique_consecutive(gid[order], return_counts=True)
    counts = counts.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # tiles: (first row, rows, first column, columns), whole rows of one
    # group each
    tiles = []
    for c0, s in zip(starts.tolist(), counts.tolist()):
        step = max(1, budget // s)
        for r0 in range(0, s, step):
            tiles.append((c0 + r0, min(step, s - r0), c0, s))
    tiles = np.asarray(tiles, np.int64)
    pairs = tiles[:, 1] * tiles[:, 3]
    w = torch.zeros(order.shape[0], dtype=torch.float64, device=dev)
    i0 = 0
    while i0 < len(tiles):
        i1 = i0 + max(1, int(np.searchsorted(np.cumsum(pairs[i0:]), budget,
                                             side="right")))
        t = torch.as_tensor(tiles[i0:i1], device=dev)
        npair = t[:, 1] * t[:, 3]
        tile = torch.repeat_interleave(torch.arange(t.shape[0], device=dev),
                                       npair)
        k = torch.arange(int(npair.sum()), device=dev) - \
            (torch.cumsum(npair, 0) - npair)[tile]
        i = t[tile, 0] + k // t[tile, 3]
        j = t[tile, 2] + k % t[tile, 3]
        keep = i != j
        i, j = i[keep], j[keep]
        d2 = dist2(p[i], p[j], box)
        w.index_add_(0, i, -G * m[j] / torch.sqrt(d2 + eps * eps))
        i0 = i1
    W[order] = w * m
    return W


def unbound_share(pos, vel, mass, pfof: torch.Tensor, checked: torch.Tensor,
                  prm: "Params") -> float:
    """Share of the members of the structures marked in ``checked``
    ((ng + 1,) bool) that are unbound in their structure as it stands:
    Eratio x T + W > 0, W the direct float64 potential of the
    structure's members, T in the frame of their centre of mass."""
    ng1 = checked.shape[0]
    gid = torch.where(checked[torch.clamp(pfof, 0, ng1 - 1)], pfof, 0)
    members = torch.nonzero(gid > 0).squeeze(1)
    nm = int(members.numel())
    if nm == 0:
        return 0.0
    W = direct_potential(pos, mass, gid, prm.G, prm.eps, prm.box)[members]
    # the members alone: the other particles add nothing to the sums
    g = gid[members]
    m = mass[members].double()
    v = vel[members].double()
    msum = torch.zeros(ng1, dtype=torch.float64, device=pos.device
                       ).index_add_(0, g, m)
    vcm = torch.zeros(ng1, 3, dtype=torch.float64, device=pos.device
                      ).index_add_(0, g, v * m[:, None]) / \
        torch.clamp_min(msum, 1e-300)[:, None]
    T = 0.5 * m * ((v - vcm[g]) ** 2).sum(1)
    unbound = prm.eratio * T + W > 0
    return float(unbound.sum()) / nm


def subhalo_held(pfof: torch.Tensor, parent: Optional[np.ndarray],
                 sub_of: torch.Tensor, n_sub: int) -> np.ndarray:
    """(n_sub,) for each planted subhalo, the most of its particles that
    one substructure (a structure with a parent) holds."""
    dev = pfof.device
    best = torch.zeros(n_sub, dtype=torch.int64, device=dev)
    if parent is None:
        return best.cpu().numpy()
    is_sub = torch.as_tensor(np.asarray(parent) > 0, device=dev)
    sel = (sub_of >= 0) & (pfof > 0)
    sel &= is_sub[torch.clamp(pfof, 0, is_sub.shape[0] - 1)]
    s, g = sub_of[sel], pfof[sel]
    span = int(pfof.max()) + 1
    uk, cnt = torch.unique(s * span + g, return_counts=True)
    best = best.scatter_reduce(0, uk // span, cnt, "amax")
    return best.cpu().numpy()


def subhalo_numbers(pfof: torch.Tensor, parent: Optional[np.ndarray],
                    sub_of: torch.Tensor, sub_sizes: np.ndarray,
                    sub_host: np.ndarray) -> Dict[str, float]:
    """``subhalos_missed``: share of the planted subhalos of which no
    substructure holds half; ``hosts_missed``: share of their hosts in
    which that is so for every one."""
    held = subhalo_held(pfof, parent, sub_of, len(sub_sizes))
    found = held * 2 >= sub_sizes
    hosts = np.unique(sub_host)
    any_found = np.zeros(len(hosts), bool)
    np.logical_or.at(any_found, np.searchsorted(hosts, sub_host), found)
    return {"subhalos_missed": float(1.0 - found.mean()),
            "hosts_missed": float(1.0 - any_found.mean())}


def nearest_grouped_dm(pos, vel, ptype, pfof, rows, b3d: float, box: float,
                       velfac: float) -> torch.Tensor:
    """For baryon ``rows``, the grouped dark-matter particle nearest in the
    phase-space metric dx^2/b^2 + dv^2/(s^2 velfac^2) (s^2 the grouped
    dark matter's velocity dispersion, unweighted) within 1 + DELTA
    (VELOCIraptor's association), as a particle index, or -1."""
    dev = pos.device
    dm = torch.nonzero((ptype == 1) & (pfof > 0)).squeeze(1)
    arg = torch.full((rows.numel(),), -1, dtype=torch.int64, device=dev)
    if dm.numel() == 0 or rows.numel() == 0:
        return arg
    v = vel[dm].double()
    s2 = float(((v - v.mean(0)) ** 2).sum(1).mean())
    ellv2 = max(s2, 1e-30) * velfac ** 2
    best = torch.full((rows.numel(),), math.inf, dtype=torch.float64,
                      device=dev)
    lim = 1 + groups.DELTA
    for qi, rj in neighbour_pairs(pos[rows], pos[dm], b3d * lim, box):
        q = dist2(pos[rows[qi]], pos[dm[rj]], box) / (b3d * b3d) + \
            ((vel[rows[qi]].double() - vel[dm[rj]].double()) ** 2).sum(1) / \
            ellv2
        keep = q <= lim
        qi, rj, q = qi[keep], rj[keep], q[keep]
        best = best.scatter_reduce(0, qi, q, "amin")
        hit = q == best[qi]
        arg[qi[hit]] = dm[rj[hit]]
    return arg


def baryon_numbers(pos, vel, ptype, pfof, top_of, b3d: float, box: float,
                   velfac: float) -> Dict[str, float]:
    """``baryons_wrong``: grouped baryons whose nearest grouped DM is not
    in their structure tree, or who have none; ``baryons_missed``: share
    of the baryons with a nearest grouped DM that are in no group."""
    bar = torch.nonzero(ptype != 1).squeeze(1)
    arg = nearest_grouped_dm(pos, vel, ptype, pfof, bar, b3d, box, velfac)
    grouped = pfof[bar] > 0
    tree_b = top_of[pfof[bar]]
    tree_d = torch.where(arg >= 0, top_of[pfof[torch.clamp_min(arg, 0)]], -1)
    wrong = grouped & (tree_b != tree_d)
    near = arg >= 0
    missed = near & ~grouped
    return {"baryons_wrong": float(wrong.sum()),
            "baryons_missed": float(missed.sum()) / max(int(near.sum()), 1)}


def compare(snap, prm: Params, cand, device=None) -> Dict[str, float]:
    """The numbers of candidate catalog ``cand`` (``pfof``, ``ngroups``,
    ``hostid``, ``parent``, ``hierarchy_level``, ``props``, ``pfof3d``)
    on snapshot ``snap``."""
    dev = device or snap.pos.device
    pos, vel, mass = snap.pos.to(dev), snap.vel.to(dev), snap.mass.to(dev)
    ptype = None if snap.ptype is None else snap.ptype.to(dev).long()
    ng = int(cand.ngroups)
    pf_np = np.asarray(cand.pfof, np.int64)
    if pf_np.shape != (pos.shape[0],):
        raise ValueError("the catalog's group ids do not match the snapshot")
    pfof = torch.as_tensor(pf_np, device=dev)
    hostid = cand.hostid if cand.hostid is not None else \
        np.full(ng + 1, -1, np.int64)
    top_np = tops(hostid, ng)
    top_of = torch.as_tensor(top_np, device=dev)
    out: Dict[str, float] = {}

    # the field search's 3D groups: of the dark matter where a baryon
    # search ran, else of every particle (no copy of the arrays)
    if prm.baryons and ptype is not None:
        dmi = torch.nonzero(ptype == 1).squeeze(1)
        dpos, dvel, dmass, tree = pos[dmi], vel[dmi], mass[dmi], \
            top_of[pfof[dmi]]
    else:
        dpos, dvel, dmass, tree = pos, vel, mass, top_of[pfof]
    p3 = torch.as_tensor(np.asarray(cand.pfof3d, np.int64), device=dev) \
        if cand.pfof3d is not None else tree
    if p3.shape != tree.shape:
        raise ValueError("the catalog's 3D ids do not match the snapshot")
    part3 = groups.fof(dpos, prm.b3d, prm.box)
    out["fof3d_wrong"] = float(groups.sandwich_violations(
        p3, part3, prm.halo_min))
    out["fof_ambiguous_pairs"] = float(part3.ambiguous_pairs)

    # the reference's own field groups (a label per searched particle),
    # where the FOF-particle SO needs them
    own = None
    if prm.adaptive6d:
        sub, part6 = _fof6d_adaptive(dpos, dvel, dmass, p3, prm)
        if prm.trees_are_groups:
            # each tree is a whole 6D group, and nothing outside the 3D
            # groups is grouped
            wrong = groups.sandwich_violations(tree[sub], part6,
                                               prm.halo_min) + \
                int(((tree > 0) & (p3 <= 0)).sum())
        else:
            own = torch.full_like(tree, -1)
            own[sub] = sub[part6.possible]
            wrong = groups.subset_violations(tree, own, p3 > 0)
        out["fof6d_wrong"] = float(wrong)
        out["fof6d_ambiguous_pairs"] = float(part6.ambiguous_pairs)
        del sub, part6
    elif prm.run6d:
        out["fof6d_wrong"] = float(_fof6d_wrong(dpos, dvel, dmass, part3,
                                                tree, prm))
    del p3
    fof_gid = None
    if prm.inclusive in (1, 2) and not prm.trees_are_groups:
        if own is None:
            own = _fof6d_labels(dpos, dvel, dmass, part3, prm)[0] \
                if prm.run6d else part3.possible
            if own is None:
                own = torch.full_like(tree, -1)
        fof_gid = _field_groups(own, tree, ng + 1)
        if prm.baryons and ptype is not None:
            # the pre-unbind groups hold dark matter alone
            fof_gid = torch.zeros_like(pfof).index_copy_(0, dmi, fof_gid)
    del part3, dpos, dvel, dmass, tree, own

    out["hierarchy_wrong"] = float(hierarchy_wrong(
        pf_np, ng, cand.hostid, cand.parent, cand.hierarchy_level,
        orphans=prm.baryons))

    ref = catalog.group_quantities(pos, vel, mass, pfof, ng, prm.box,
                                   ptype=ptype if ptype is not None and
                                   bool((ptype != 1).any()) else None,
                                   iterate_cm=prm.iterate_cm)
    out["props_gap"] = props_gap(cand.props, ref, ng, float(mass.min()))
    cg = centre_gaps(cand.props, ref, ng, prm.box) if ng else \
        torch.zeros(1)
    out["centre_gap"] = float(cg.max())
    out["centre_off_share"] = float((cg > CENTRE_TOL).double().mean())

    if prm.inclusive == 3 and ng > 0:
        field = np.nonzero(np.asarray(hostid[1:ng + 1]) == -1)[0] + 1
        ft = torch.as_tensor(field, device=dev)
        M, R = catalog.field_so(
            pos, mass, ref, ft, prm.lnthr,
            prm.e["Spherical_overdensity_search_factor"],
            prm.e["Spherical_overdensity_min_halo_factor"], prm.halo_min,
            prm.box)
        out["so_off_share"] = so_off_share(cand.props, M, R, field)
    elif prm.inclusive in (1, 2) and ng > 0:
        field = np.nonzero(np.asarray(hostid[1:ng + 1]) == -1)[0] + 1
        if fof_gid is None:
            fof_gid = top_of[pfof]
        M, R = catalog.fof_so(
            pos, mass, fof_gid, torch.as_tensor(field, device=dev),
            prm.lnthr, prm.e["Spherical_overdensity_min_halo_factor"],
            prm.min_size, prm.box)
        out["so_off_share"] = so_off_share(cand.props, M, R, field)
    del fof_gid

    if prm.unbind_all or prm.unbind_subs:
        if prm.unbind_all:
            checked = torch.ones(ng + 1, dtype=torch.bool, device=dev)
        else:
            par = np.zeros(ng + 1, np.int64) if cand.parent is None else \
                np.asarray(cand.parent, np.int64)[:ng + 1]
            checked = torch.as_tensor(par > 0, device=dev)
        checked[0] = False
        out["unbound_share"] = unbound_share(pos, vel, mass, pfof, checked,
                                             prm)

    if snap.sub_sizes is not None and len(snap.sub_sizes):
        out.update(subhalo_numbers(pfof, cand.parent, snap.sub_of.to(dev),
                                   snap.sub_sizes, snap.sub_host))

    if prm.baryons and ptype is not None:
        out.update(baryon_numbers(
            pos, vel, ptype, pfof, top_of, prm.b3d, prm.box,
            prm.e["Halo_velocity_linking_length_factor"]))
    return out


def vscale2_6d(vel, mass, labels: torch.Tensor, sel: torch.Tensor,
               vfac: float) -> float:
    """The 6D velocity scale: the mass-weighted velocity dispersion^2 of
    the largest group (``labels`` restricted to ``sel``) times vfac^2."""
    n = labels.shape[0]
    cnt = torch.bincount(torch.where(sel, labels, n), minlength=n + 1)[:n]
    big = int(torch.argmax(cnt))
    m = torch.where(labels == big, mass.double(), 0.0)
    v = vel.to(torch.float64, copy=True)
    vm = (v * m[:, None]).sum(0) / m.sum()
    # ((v - vm) ** 2).sum(1) * m, in place: one (n, 3) array at a time
    d2 = v.sub_(vm).square_().sum(1).mul_(m)
    return float(d2.sum() / m.sum()) * vfac ** 2


def _fof6d_labels(pos, vel, mass, part3, prm: Params):
    """FOF6D's possible 6D groups (links inside one possible 3D group of
    halo_min or more, the largest group's velocity scale): (a label per
    point, -1 outside those 3D groups, or None where there are none;
    the points inside them)."""
    lab3 = part3.possible
    big3 = groups.sizes_of(lab3) >= prm.halo_min
    vs2 = vscale2_6d(vel, mass, lab3, big3,
                     prm.e["Halo_6D_vel_linking_length_factor"])
    b6 = prm.b3d * prm.e["Halo_6D_linking_length_factor"]
    sub = torch.nonzero(big3).squeeze(1)
    if sub.numel() == 0:
        return None, big3
    sv = vel[sub].double()
    sl = lab3[sub]

    def extra(i, j):
        dv2 = ((sv[i] - sv[j]) ** 2).sum(1)
        return dv2 / vs2, sl[i] == sl[j]

    part6 = groups.fof(pos[sub], b6, prm.box, extra=extra)
    lab6 = torch.full((pos.shape[0],), -1, dtype=torch.int64,
                      device=pos.device)
    lab6[sub] = sub[part6.possible]
    return lab6, big3


def _fof6d_wrong(pos, vel, mass, part3, prog_tree, prm: Params) -> int:
    """DM particles of a structure tree not inside one possible 6D group
    of FOF6D (``_fof6d_labels``)."""
    lab6, big3 = _fof6d_labels(pos, vel, mass, part3, prm)
    if lab6 is None:
        return int((prog_tree > 0).sum())
    return groups.subset_violations(prog_tree, lab6, big3)


# A group's velocity scale in the program is a float64 sum of float32
# products: the reference's float64 value can differ from it by a few
# parts in 10^7.  Each scale gets the 3D sandwich's margin (groups.DELTA)
# either way, so that rounding alone never fails a sound catalog: a pair
# links for certain under the scale shrunk by it, possibly under the
# scale grown by it.
SCALE_MARGIN = groups.DELTA


def dispersion2(vel, mass, labels: torch.Tensor, n1: int) -> torch.Tensor:
    """(n1,) float64 mass-weighted velocity dispersion^2 of each label's
    points about their mass-weighted mean velocity."""
    v, m = vel.double(), mass.double()
    msum = torch.clamp_min(torch.zeros(n1, dtype=torch.float64,
                                       device=v.device).index_add_(
        0, labels, m), 1e-300)
    vm = torch.zeros(n1, 3, dtype=torch.float64, device=v.device
                     ).index_add_(0, labels, v * m[:, None]) / msum[:, None]
    d2 = ((v - vm[labels]) ** 2).sum(1) * m
    return torch.zeros(n1, dtype=torch.float64, device=v.device
                       ).index_add_(0, labels, d2) / msum


def _fof6d_adaptive(pos, vel, mass, p3: torch.Tensor, prm: Params):
    """FOF6DADAPTIVE's 6D groups of the catalog's 3D groups ``p3`` (> 0;
    held to FOF by ``fof3d_wrong``): a pair links inside one 3D group g
    when d^2 / b6^2 + |dv|^2 / s_g^2 <= 1, s_g^2 the group's own
    mass-weighted velocity dispersion^2 times
    Halo_6D_vel_linking_length_factor^2 (with SCALE_MARGIN).  Returns
    (the points of the 3D groups, their 6D partition)."""
    sub = torch.nonzero(p3 > 0).squeeze(1)
    g = p3[sub]
    n1 = int(g.max()) + 1 if sub.numel() else 1
    s2 = torch.clamp_min(dispersion2(vel[sub], mass[sub], g, n1) *
                         prm.e["Halo_6D_vel_linking_length_factor"] ** 2,
                         1e-30)
    sv = vel[sub].double()

    def extra(i, j):
        term = ((sv[i] - sv[j]) ** 2).sum(1) / s2[g[i]]
        return term, g[i] == g[j], term * SCALE_MARGIN

    return sub, groups.fof(pos[sub], prm.b3d *
                           prm.e["Halo_6D_linking_length_factor"], prm.box,
                           extra=extra)


def _field_groups(own: torch.Tensor, tree: torch.Tensor, ng1: int
                  ) -> torch.Tensor:
    """(n,) the field structure whose pre-unbind group each point is in
    (0: none): a tree's group is the reference group ``own`` (a label per
    point, -1 none) of its members with the lowest label."""
    n = own.shape[0]
    sel = (tree > 0) & (own >= 0)
    low = torch.full((ng1,), n, dtype=torch.int64, device=own.device
                     ).scatter_reduce(0, tree[sel], own[sel], "amin")
    tops = torch.nonzero(low < n).squeeze(1)
    owner = torch.zeros(n + 1, dtype=torch.int64, device=own.device)
    owner[low[tops]] = tops
    return torch.where(own >= 0, owner[torch.clamp_min(own, 0)], 0)
