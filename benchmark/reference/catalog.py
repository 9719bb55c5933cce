"""Catalog quantities of given groups, plain torch (float64 by default).

For each group: its particle count, mass, centre of mass (positions
taken about the group's lowest-index member, minimum image), centre-of-
mass velocity, size (largest member distance from the centre) and, per
particle type, mass; for the field halos, spherical overdensities from
all particles around the centre: the enclosed density on 128 log-spaced
radii of the search sphere, and the first inside-out crossing of each
threshold with log-log interpolation (VELOCIraptor's GetSOMasses and
CalculateSphericalOverdensity).  ``dtype`` sets the arithmetic, so the
same code serves the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .pairs import min_image, neighbour_pairs


def cosmology(e: Dict[str, float], a: float) -> Dict[str, float]:
    """Critical and background densities and the Bryan & Norman
    overdensity at scale factor ``a`` from the config's numbers
    (VELOCIraptor CalcCosmoParams)."""
    om, ol = e["Omega_m"], e["Omega_Lambda"]
    ok = 1.0 - om - ol
    H0 = e["h_val"] * e["Hubble_unit"]
    G = e["Gravity"]
    H = H0 * math.sqrt(ok / a ** 2 + om / a ** 3 + ol)
    rhocrit = 3.0 * H * H / (8.0 * math.pi * G)
    rhobg = 3.0 * H0 * H0 / (8.0 * math.pi * G) * om / a ** 3
    x = -(ok / a ** 2 + ol) / (ok / a ** 2 + om / a ** 3 + ol)
    bn98 = 18.0 * math.pi ** 2 + 82.0 * x - 39.0 * x * x
    vir = e.get("Virial_density", -1.0)
    return dict(rhocrit=rhocrit, rhobg=rhobg, virBN98=bn98,
                virlevel=bn98 if vir < 0 else vir)


def so_thresholds(e: Dict[str, float], extra_crit: List[float],
                  a: float) -> List[float]:
    """ln densities of Mvir, M200c, M200m, M500c, MBN98, then each
    ``Overdensity_values_in_critical_density``."""
    c = cosmology(e, a)
    return [math.log(max(c["virlevel"] * c["rhobg"], 1e-30)),
            math.log(200.0 * c["rhocrit"]), math.log(200.0 * c["rhobg"]),
            math.log(500.0 * c["rhocrit"]),
            math.log(c["virBN98"] * c["rhocrit"])] + \
        [math.log(t * c["rhocrit"]) for t in extra_crit]


def _shrinking_sphere(pu, v, m, g, num, cm, cmv, n1, dtype,
                      cmfrac: float = 0.1, fac: float = 0.7,
                      minnum: int = 10):
    """VELOCIraptor's iterated centre (GetCM): from the centre of mass
    and a sphere through the farthest member, shrink the sphere by
    ``fac`` while it holds at least max(cmfrac * num, minnum) members,
    taking the centre of mass of what it holds; the velocity is that of
    the members inside the last sphere.  Groups with fewer than
    minnum / fac members keep the plain centre of mass."""
    dev = pu.device

    def ssum(x):
        shape = (n1,) + tuple(x.shape[1:])
        return torch.zeros(shape, dtype=dtype, device=dev).index_add_(0, g, x)

    r2 = ((pu - cm[g]) ** 2).sum(1)
    ri2 = torch.zeros(n1, dtype=dtype, device=dev).scatter_reduce(
        0, g, r2, "amax")
    rv2 = ri2.clone()
    active = num * fac >= minnum
    active[0] = False
    c = cm.clone()
    # members on one point (a lowered precision) never leave the sphere:
    # stop where it has shrunk to nothing
    for _ in range(200):
        if not bool(active.any()):
            break
        ri2 = ri2 * fac * fac
        inside = (((pu - c[g]) ** 2).sum(1) <= ri2[g]) & active[g]
        w = torch.where(inside, m, 0.0)
        enc = ssum(w)
        nin = torch.bincount(g[inside], minlength=n1)
        cnew = ssum(pu * w[:, None]) / torch.clamp_min(enc, 1e-30)[:, None]
        ok = (nin >= torch.clamp_min(cmfrac * num, minnum)) & active & \
            (ri2 > 0)
        c = torch.where(ok[:, None], cnew, c)
        rv2 = torch.where(ok, ri2, rv2)
        active = ok
    inside = ((pu - c[g]) ** 2).sum(1) <= rv2[g]
    w = torch.where(inside, m, 0.0)
    cv = ssum(v * w[:, None]) / torch.clamp_min(ssum(w), 1e-30)[:, None]
    it = num * fac >= minnum
    return c, torch.where(it[:, None], cv, cmv)


def group_quantities(pos, vel, mass, gid, ng: int, box: float, ptype=None,
                     iterate_cm: bool = False,
                     dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """Per-group (rows 0..ng, row 0 unused) num, mass, centre (with
    ``iterate_cm`` the shrinking-sphere one), its velocity, size (from
    that centre) and, with ``ptype``, the mass of types 0 and 4."""
    dev = pos.device
    sel = torch.nonzero(gid > 0).squeeze(1)
    g = gid[sel]
    p = pos[sel].to(dtype)
    v = vel[sel].to(dtype)
    m = mass[sel].to(dtype)
    n1 = ng + 1
    first = torch.full((n1,), sel.numel(), dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, g, torch.arange(sel.numel(),
                                                    device=dev), "amin")
    ref = p[torch.clamp(first, max=max(sel.numel() - 1, 0))][g]
    pu = ref + min_image(p - ref, box)
    num = torch.bincount(g, minlength=n1)
    msum = torch.zeros(n1, dtype=dtype, device=dev).index_add_(0, g, m)
    den = torch.clamp_min(msum, 1e-30)[:, None]
    cm = torch.zeros(n1, 3, dtype=dtype, device=dev).index_add_(
        0, g, pu * m[:, None]) / den
    cmv = torch.zeros(n1, 3, dtype=dtype, device=dev).index_add_(
        0, g, v * m[:, None]) / den
    if iterate_cm:
        cm, cmv = _shrinking_sphere(pu, v, m, g, num, cm, cmv, n1, dtype)
    r = torch.sqrt(((pu - cm[g]) ** 2).sum(1))
    size = torch.zeros(n1, dtype=dtype, device=dev).scatter_reduce(
        0, g, r, "amax")
    out = dict(num=num, mass=msum, cm=torch.remainder(cm, box), cmvel=cmv,
               size=size)
    if ptype is not None:
        t = ptype[sel]
        for name, code in (("gas", 0), ("star", 4)):
            w = torch.where(t == code, m, 0.0)
            out["M_" + name] = torch.zeros(n1, dtype=dtype,
                                           device=dev).index_add_(0, g, w)
    return out


def search_radii(gmass, gsize, min_lnrho: float, fac: float):
    """SO search radius: size x fac, inflated while the group's mean
    density exceeds half the lowest threshold."""
    lnfac = -math.log(4.0 * math.pi / 3.0) - min_lnrho
    radfac = torch.clamp_min(torch.exp(
        (torch.log(torch.clamp_min(gmass, 1e-30)) -
         3.0 * torch.log(torch.clamp_min(gsize, 1e-30)) + lnfac) / 3.0), 1.0)
    return torch.clamp_min(gsize, 1e-30) * fac * radfac


def spherical_overdensities(pos, mass, centres, rsearch, lnthr: List[float],
                            minnum, first_mass: float, box: float,
                            nbins: int = 128, umin: float = 3e-3,
                            dtype=torch.float64, budget=None):
    """(M, R), each (H, nthr): for H centres the first inside-out
    crossing of each ln-density threshold by the enclosed density of
    all particles within ``rsearch``, on ``nbins`` radii (bin 0 up to
    umin * rsearch, then log-spaced to rsearch), log-log interpolated;
    0 where none is found or the mass is under ``first_mass``."""
    dev = pos.device
    H = centres.shape[0]
    nthr = len(lnthr)
    Mout = torch.zeros(H, nthr, dtype=torch.float64, device=dev)
    Rout = torch.zeros(H, nthr, dtype=torch.float64, device=dev)
    if H == 0:
        return Mout, Rout
    lnumin = math.log(umin)
    dlog = -lnumin / (nbins - 1)
    c = centres.to(dtype)
    rs = rsearch.to(dtype)
    # octave classes of search radius, each on its own grid
    cls = torch.ceil(torch.log2(torch.clamp_min(rs.max() / rs, 1.0))).long()
    Mh = torch.zeros(H * nbins, dtype=torch.float64, device=dev)
    Nh = torch.zeros(H * nbins, dtype=torch.int64, device=dev)
    for k in torch.unique(cls).tolist():
        hsel = torch.nonzero(cls == k).squeeze(1)
        reach = float(rs[hsel].max())
        for qi, rj in neighbour_pairs(c[hsel].float(), pos, reach, box,
                                      budget):
            h = hsel[qi]
            d = min_image(pos[rj].to(dtype) - c[h], box)
            u = torch.sqrt((d * d).sum(1)) / rs[h]
            mj = mass[rj].to(dtype)
            ok = (u <= 1.0) & (mj > 0)
            b = 1 + torch.floor((torch.log(torch.clamp_min(u, 1e-30)) -
                                 lnumin) / dlog).long()
            flat = (h * nbins + torch.clamp(b, 0, nbins - 1))[ok]
            Mh.index_add_(0, flat, mj[ok].double())
            Nh += torch.bincount(flat, minlength=H * nbins)
    Mc = torch.cumsum(Mh.view(H, nbins).to(dtype), 1)
    Nc = torch.cumsum(Nh.view(H, nbins), 1)
    lnu = lnumin + dlog * torch.arange(nbins, dtype=dtype, device=dev)
    redge = rs[:, None] * torch.exp(lnu)[None, :]
    lnrho = torch.log(torch.clamp_min(Mc, 1e-30)) - 3.0 * torch.log(
        torch.clamp_min(redge, 1e-30)) + math.log(3.0 / (4.0 * math.pi))
    usable = (Nc >= minnum[:, None]) & (Mc > 0)
    cols = torch.arange(nbins, device=dev)
    rows = torch.arange(H, device=dev)
    for t, thr in enumerate(lnthr):
        below = usable & (lnrho < thr)
        kk = torch.where(below, cols[None, :], nbins).amin(1)
        found = kk < nbins
        kc = torch.clamp_max(kk, nbins - 1)
        kp = torch.clamp_min(kc - 1, 0)
        drho = lnrho[rows, kc] - lnrho[rows, kp]
        safe = drho.abs() > 1e-12
        g1 = torch.where(safe, (lnu[kc] - lnu[kp]) / drho, 0.0)
        g2 = torch.where(safe, torch.log(
            Mc[rows, kc] / torch.clamp_min(Mc[rows, kp], 1e-30)) / drho, 0.0)
        delta = thr - lnrho[rows, kc]
        R = redge[rows, kc] * torch.exp(g1 * delta)
        M = Mc[rows, kc] * torch.exp(g2 * delta)
        bad = ~found | (M < first_mass)
        Mout[:, t] = torch.where(bad, 0.0, M).double()
        Rout[:, t] = torch.where(bad, 0.0, R).double()
    return Mout, Rout


def field_so(pos, mass, q: Dict[str, torch.Tensor], field: torch.Tensor,
             lnthr: List[float], search_fac: float, minhalofac: float,
             minsize: int, box: float, dtype=torch.float64):
    """(M, R) of the field halos ``field`` (group ids) around their
    centres of mass, as the catalog's inclusive masses of all particles
    (Inclusive_halo_masses=3)."""
    num = q["num"][field]
    rsearch = search_radii(q["mass"][field].to(dtype),
                           q["size"][field].to(dtype),
                           min(lnthr) - math.log(2.0), search_fac)
    minnum = torch.clamp_min((minhalofac * num.double() + 1).long(),
                             int(minsize * minhalofac + 1))
    return spherical_overdensities(pos, mass, q["cm"][field], rsearch,
                                   lnthr, minnum, float(mass.min()), box,
                                   dtype=dtype)


def fof_so(pos, mass, gid, field: torch.Tensor, lnthr: List[float],
           minhalofac: float, minsize: int, box: float,
           dtype=torch.float64):
    """(M, R), each (H, nthr): the SO masses and radii of the field halos
    ``field`` from their own FOF particles alone (``gid`` the halo of each
    particle, 0 none), as the catalog's inclusive masses of
    Inclusive_halo_masses 1 and 2 (VELOCIraptor's GetInclusiveMasses):
    the members sorted by their distance from the members' centre of
    mass (minimum image about the lowest-index member); at each member
    the enclosed mass over the sphere through it; the first member, from
    the centre out and past the first ``minnum``, at which that density
    falls below a threshold, log-log interpolated with the member inside
    it; the halo's mass and size where none does; 0 where the mass is
    under the innermost member's."""
    dev = pos.device
    H = field.shape[0]
    nthr = len(lnthr)
    top = max(int(gid.max()) if gid.numel() else 0,
              int(field.max()) if H else 0)
    slot = torch.full((top + 1,), -1, dtype=torch.int64, device=dev)
    slot[field] = torch.arange(H, device=dev)
    Mout = torch.zeros(H, nthr, dtype=torch.float64, device=dev)
    Rout = torch.zeros(H, nthr, dtype=torch.float64, device=dev)
    sel = torch.nonzero(gid > 0).squeeze(1)
    h = slot[gid[sel]]
    sel, h = sel[h >= 0], h[h >= 0]
    if h.numel() == 0:
        return Mout, Rout
    p = pos[sel].to(dtype)
    m = mass[sel].to(dtype)
    first = torch.full((H,), sel.numel(), dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, h, torch.arange(sel.numel(),
                                                    device=dev), "amin")
    ref = p[torch.clamp(first, max=sel.numel() - 1)][h]
    pu = ref + min_image(p - ref, box)
    msum = torch.zeros(H, dtype=dtype, device=dev).index_add_(0, h, m)
    cm = torch.zeros(H, 3, dtype=dtype, device=dev).index_add_(
        0, h, pu * m[:, None]) / torch.clamp_min(msum, 1e-30)[:, None]
    r = torch.sqrt(torch.clamp_min(((pu - cm[h]) ** 2).sum(1), 1e-30))
    # members by halo, then by radius
    order = torch.argsort(r)
    order = order[torch.argsort(h[order], stable=True)]
    h, r, m = h[order], r[order], m[order]
    num = torch.bincount(h, minlength=H)
    start = torch.cumsum(num, 0) - num
    k = torch.arange(h.numel(), device=dev)
    rank = k - start[h]
    # a halo with no member starts past the end: never read through h
    s0 = torch.clamp(start, max=h.numel() - 1)
    mc = torch.cumsum(m, 0)
    Mcum = mc - (mc[s0] - m[s0])[h]
    lnrho = torch.log(Mcum) - 3.0 * torch.log(r) + \
        math.log(3.0 / (4.0 * math.pi))
    minnum = torch.clamp_min((minhalofac * num.double() + 1).long(),
                             int(minsize * minhalofac + 1))
    size = torch.zeros(H, dtype=dtype, device=dev).scatter_reduce(
        0, h, r, "amax")
    innermost = m[s0]
    for t, thr in enumerate(lnthr):
        cond = (lnrho < thr) & (rank >= minnum[h])
        kk = torch.full((H,), h.numel(), dtype=torch.int64, device=dev)
        kk = kk.scatter_reduce(0, h[cond], k[cond], "amin")
        found = kk < h.numel()
        kc = torch.clamp_max(kk, h.numel() - 1)
        kp = torch.maximum(kc - 1, s0)
        drho = lnrho[kc] - lnrho[kp]
        safe = drho.abs() > 1e-12
        g1 = torch.where(safe, torch.log(r[kc] / r[kp]) / drho, 0.0)
        g2 = torch.where(safe, torch.log(Mcum[kc] / Mcum[kp]) / drho, 0.0)
        delta = thr - lnrho[kc]
        R = torch.where(found, r[kc] * torch.exp(g1 * delta), size)
        M = torch.where(found, Mcum[kc] * torch.exp(g2 * delta), msum)
        bad = M < innermost
        Mout[:, t] = torch.where(bad, 0.0, M).double()
        Rout[:, t] = torch.where(bad, 0.0, R).double()
    return Mout, Rout
