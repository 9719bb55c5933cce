"""Bulk halo properties by segment reductions (port of
velociraptor_stf_tpu/models/properties.py: ``compute_properties``
(``_props_geom`` + ``_props_kin``), ``compute_aperture_properties``,
``compute_rvmax_properties``, ``compute_energies`` and
``property_bundle``).

Every public function sorts its particles by group once (stably, so each
group keeps its members' order) and works on the group-sorted arrays:
segment sums then add each group's members in index order, as the
reference's scatter-adds do on the CPU, and give the same result on every
run on a card.  Per-group arrays have num_groups + 1 rows, row 0 being the
untagged particles.  The reference's ``jax.lax.while_loop`` (shrinking
sphere) is a host loop with one ``.any()`` per round; its jitted padding
classes are gone.  Per-particle-type properties (baryons) are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops import segments as seg

from velociraptor_stf_tpu.utils import config as C

PROPCMMINNUM = 10  # reference allvars.h:253

Props = Dict[str, torch.Tensor]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + \
        a[..., 2] * b[..., 2]


def _f(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``x`` in ``like``'s dtype and device."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _ssum(values: torch.Tensor, g: torch.Tensor, ng1: int) -> torch.Tensor:
    """Segment sum over group-sorted rows."""
    return seg.segment_sum(values, g, ng1, presorted=True)


def _first_crossing(cond: torch.Tensor, g_s: torch.Tensor,
                    ng1: int) -> torch.Tensor:
    """Per group: smallest sorted index where ``cond`` holds, else n."""
    n = cond.shape[0]
    idx = torch.arange(n, device=cond.device)
    return seg.segment_min(torch.where(cond, idx, n), g_s, ng1)


def group_sorted(pfof: torch.Tensor, *arrays: Optional[torch.Tensor]):
    """(pfof, *arrays) permuted stably into group order (None stays
    None)."""
    perm = seg.sort_by_group(pfof)
    return (pfof[perm],) + tuple(None if a is None else a[perm]
                                 for a in arrays)


def _eig_shape(iten: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(q, s, eigenvectors) of (ng1, 3, 3) mass distribution tensors;
    eigenvalues ascending, as ``jnp.linalg.eigh`` returns them."""
    evals, evecs = torch.linalg.eigh(iten)
    lam = torch.clamp_min(evals[:, 2], 1e-30)
    return (torch.sqrt(evals[:, 1] / lam),
            torch.sqrt(torch.clamp_min(evals[:, 0], 0.0) / lam), evecs)


def _sigma(disp: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp_min(torch.linalg.det(disp), 1e-30),
                     1.0 / 6.0)


def compute_properties(pos, vel, mass, pfof, num_groups: int, **kw
                       ) -> Props:
    """Geometry (CM, radius sort, SO, Vmax, half-mass radius) then
    kinematics (dispersion, J, Krot, shape, cNFW) of groups
    1..num_groups.  Keywords as the reference's ``_props_geom``."""
    refpos = kw.pop("refpos", None)
    refvel = kw.pop("refvel", None)
    pfof, pos, vel, mass = group_sorted(pfof, pos, vel, mass)
    return _properties(pos, vel, mass, pfof, num_groups, refpos=refpos,
                       refvel=refvel, **kw)


def _properties(pos, vel, mass, pfof, num_groups, *, G=43.0211349,
                calc_shape=True, **kw) -> Props:
    props, ref, vref, posu, gsize = _props_geom(pos, vel, mass, pfof,
                                                num_groups, G=G, **kw)
    return _props_kin(posu, vel, mass, pfof, num_groups, props, ref, vref,
                      gsize, G=G, calc_shape=calc_shape)


def _props_geom(pos, vel, mass, pfof, num_groups: int, *,
                G: float = 43.0211349, boxsize: Optional[float] = None,
                rhocrit: float = 1.0, rhobg: float = 1.0,
                virlevel: float = 200.0, virBN98: float = 97.0,
                so_thresholds: Sequence[float] = (), min_size: int = 20,
                so_minhalofac: float = 0.05, iIterateCM: bool = False,
                cmfrac: float = 0.1, cmadjustfac: float = 0.7,
                refpos: Optional[torch.Tensor] = None,
                refvel: Optional[torch.Tensor] = None):
    """Mass, CM (optionally by shrinking spheres), SO masses and radii,
    Vmax, half-mass radius of group-sorted particles."""
    n = pos.shape[0]
    ng1 = num_groups + 1
    m = mass if mass.dim() == 1 else torch.full((n,), float(mass),
                                                device=pos.device)
    if boxsize:
        pos = seg.unwrap_positions(pos, pfof, boxsize, num_groups)
    tagged = pfof > 0

    num = seg.group_sizes(pfof, num_groups)
    gmass = _ssum(m, pfof, ng1)
    gcm = seg.segment_mean(pos, m, pfof, ng1, presorted=True)
    gcmvel = seg.segment_mean(vel, m, pfof, ng1, presorted=True)

    # shrinking-sphere centre (reference GetCM:60-116)
    r2_all = seg.sq3(pos - gcm[pfof])
    gsize2 = seg.segment_max(torch.where(tagged, r2_all, 0.0), pfof, ng1)
    if iIterateCM:
        fac2 = cmadjustfac ** 2
        gids = torch.arange(ng1, device=pos.device)
        active = (num * cmadjustfac >= PROPCMMINNUM) & (gids > 0)
        cm, ri2, rcmv2 = gcm, gsize2, gsize2
        while bool(active.any()):
            ri2 = ri2 * fac2
            d2 = seg.sq3(pos - cm[pfof])
            inside = (d2 <= ri2[pfof]) & tagged & active[pfof]
            w = torch.where(inside, m, 0.0)
            enc = _ssum(w, pfof, ng1)
            nin = seg.segment_count(inside, pfof, ng1)
            cmnew = _ssum(pos * w[:, None], pfof, ng1) / \
                torch.clamp_min(enc, 1e-30)[:, None]
            ok = (nin >= torch.clamp_min(cmfrac * num, PROPCMMINNUM)) & \
                active
            cm = torch.where(ok[:, None], cmnew, cm)
            rcmv2 = torch.where(ok, ri2, rcmv2)
            active = ok
        gcm = cm
        # CM velocity from the particles inside the final sphere
        inside = (seg.sq3(pos - gcm[pfof]) <= rcmv2[pfof]) & tagged
        w = torch.where(inside, m, 0.0)
        enc = torch.clamp_min(_ssum(w, pfof, ng1), 1e-30)
        gcmvel_it = _ssum(vel * w[:, None], pfof, ng1) / enc[:, None]
        it_ok = num * cmadjustfac >= PROPCMMINNUM
        gcmvel = torch.where(it_ok[:, None], gcmvel_it, gcmvel)

    ref = refpos if refpos is not None else gcm
    vref = refvel if refvel is not None else gcmvel

    # radius sort + per-group cumulative mass
    r2 = seg.sq3(pos - ref[pfof])
    perm = seg.lexsort2(r2, pfof)
    g_s = pfof[perm]
    r_s = torch.sqrt(torch.clamp_min(r2[perm], 1e-30))
    m_s = m[perm]
    offsets = seg.group_offsets(g_s, num_groups)
    rank = seg.segment_rank(g_s, offsets)
    Mcum = seg.segment_cumsum(m_s, g_s, offsets)
    in_s = g_s > 0
    gsize = seg.segment_max(torch.where(in_s, r_s, 0.0), g_s, ng1)
    num_f = num.to(pos.dtype)

    # spherical overdensities (reference :5203)
    fac = torch.log(_f(3.0 / (4.0 * math.pi), pos))
    lnrho = torch.log(torch.clamp_min(Mcum, 1e-30)) - \
        3.0 * torch.log(r_s) + fac
    minnum = torch.clamp_min((so_minhalofac * num_f + 1).long(),
                             int(min_size * so_minhalofac + 1))

    def lnthr(x):
        return torch.log(torch.clamp_min(_f(x, pos), 1e-30))

    thresholds = [
        ("Mvir", "Rvir", lnthr(virlevel * rhobg)),
        ("M200c", "R200c", lnthr(rhocrit * 200.0)),
        ("M200m", "R200m", lnthr(rhobg * 200.0)),
        ("M500c", "R500c", lnthr(rhocrit * 500.0)),
        ("MBN98", "RBN98", lnthr(virBN98 * rhocrit)),
    ] + [(f"SO{i}", f"SOr{i}", lnthr(rhocrit * t))
         for i, t in enumerate(so_thresholds)]

    props: Props = {}
    first_mass = seg.segment_min(torch.where(rank == 0, m_s, math.inf),
                                 g_s, ng1)
    lo = offsets[g_s]
    so_out = {}
    for mname, rname, thr in thresholds:
        cond = (lnrho < thr) & (rank >= minnum[g_s]) & in_s
        k = _first_crossing(cond, g_s, ng1)
        found = k < n
        kc = torch.clamp_max(k, n - 1)
        # the previous sample of the same group (itself at the group start)
        kp = torch.maximum(kc - 1, lo[kc])
        rho_k, rho_p = lnrho[kc], lnrho[kp]
        drho = rho_k - rho_p
        safe = torch.abs(drho) > 1e-12
        gamma1 = torch.where(safe, torch.log(r_s[kc] / r_s[kp]) / drho, 0.0)
        gamma2 = torch.where(safe, torch.log(Mcum[kc] / Mcum[kp]) / drho,
                             0.0)
        delta = thr - rho_k
        Rso = torch.where(found, r_s[kc] * torch.exp(gamma1 * delta), gsize)
        Mso = torch.where(found, Mcum[kc] * torch.exp(gamma2 * delta), gmass)
        # zero below a single particle mass (reference :5305)
        bad = Mso < first_mass
        so_out[mname] = torch.where(bad, 0.0, Mso)
        so_out[rname] = torch.where(bad, 0.0, Rso)
    for key, v in so_out.items():
        if not key.startswith("SO"):
            props["g" + key] = v
    nso = len(so_thresholds)
    empty = torch.zeros((ng1, 0), dtype=pos.dtype, device=pos.device)
    props["SO_mass"] = torch.stack([so_out[f"SO{i}"] for i in range(nso)],
                                   -1) if nso else empty
    props["SO_radius"] = torch.stack([so_out[f"SOr{i}"] for i in range(nso)],
                                     -1) if nso else empty

    # Vmax, Rmax, half-mass radius (reference :370-420)
    vc2 = G * Mcum / r_s
    eligible = (Mcum >= gmass[g_s] /
                torch.sqrt(torch.clamp_min(num_f[g_s], 1.0))) & in_s
    vc2m = torch.where(eligible, vc2, -math.inf)
    gvmax2 = seg.segment_max(vc2m, g_s, ng1)
    kmax = _first_crossing(vc2m == gvmax2[g_s], g_s, ng1)
    kmaxc = torch.clamp_max(kmax, n - 1)
    props["gmaxvel"] = torch.sqrt(torch.clamp_min(gvmax2, 0.0))
    props["gRmaxvel"] = torch.where(kmax < n, r_s[kmaxc], 0.0)
    props["gMmaxvel"] = torch.where(kmax < n, Mcum[kmaxc], 0.0)

    khalf = _first_crossing((Mcum > 0.5 * gmass[g_s]) & in_s, g_s, ng1)
    props["gRhalfmass"] = torch.where(khalf < n,
                                      r_s[torch.clamp_max(khalf, n - 1)], 0.0)
    k2h = _first_crossing((r_s > 2.0 * props["gRhalfmass"][g_s]) & in_s,
                          g_s, ng1)
    k2c = torch.clamp(k2h - 1, 0, n - 1)
    props["gMassTwiceRhalfmass"] = torch.where(k2h < n, Mcum[k2c], gmass)

    props["num"] = num
    props["gmass"] = gmass
    props["gcm"] = gcm
    props["gcmvel"] = gcmvel
    return props, ref, vref, pos, gsize


def _props_kin(pos, vel, mass, pfof, num_groups: int, props: Props, ref,
               vref, gsize, *, G: float, calc_shape: bool = True) -> Props:
    """Dispersion, angular momentum, Krot, shape and NFW concentration on
    unwrapped group-sorted positions."""
    ng1 = num_groups + 1
    m = mass if mass.dim() == 1 else torch.full_like(pos[:, 0], float(mass))
    props = dict(props)
    gmass = props["gmass"]
    tagged = pfof > 0
    dx = pos - ref[pfof]
    r2 = seg.sq3(dx)
    dv = vel - vref[pfof]
    wt = torch.where(tagged, m, 0.0)
    msafe = torch.clamp_min(gmass, 1e-30)[:, None, None]
    gveldisp = seg.segment_outer(dv, dv, wt, pfof, ng1,
                                 presorted=True) / msafe
    props["gveldisp"] = gveldisp
    props["gsigma_v"] = _sigma(gveldisp)
    L = torch.linalg.cross(dx, dv)
    props["gJ"] = _ssum(torch.where(tagged[:, None], L * m[:, None], 0.0),
                        pfof, ng1)
    props["Ekin"] = 0.5 * _ssum(torch.where(tagged, m * seg.sq3(dv), 0.0),
                                pfof, ng1)

    # rotational support about the gJ axis (reference :430)
    jhat = props["gJ"] / torch.clamp_min(
        torch.sqrt(seg.sq3(props["gJ"])), 1e-30)[:, None]
    jh = jhat[pfof]
    Rdist2 = torch.clamp_min(r2 - _dot3(dx, jh) ** 2, 1e-30)
    krot_i = 0.5 * m * _dot3(L, jh) ** 2 / Rdist2
    props["Krot"] = _ssum(torch.where(tagged, krot_i, 0.0), pfof, ng1) / \
        torch.clamp_min(props["Ekin"], 1e-30)

    if calc_shape:
        iten = seg.segment_outer(dx, dx, wt, pfof, ng1,
                                 presorted=True) / msafe
        props["gq"], props["gs"], props["geigvec"] = _eig_shape(iten)

    # NFW concentration (reference :3656, mycNFW Newton)
    R200c, M200c = props["gR200c"], props["gM200c"]
    vvir2 = G * M200c / torch.clamp_min(R200c, 1e-30)
    VmaxVvir2 = props["gmaxvel"] ** 2 / torch.clamp_min(vvir2, 1e-30)

    def nfw_f(c):
        return 0.216 * c / (torch.log1p(c) - c / (1.0 + c))

    c = torch.full((ng1,), 10.0, dtype=pos.dtype, device=pos.device)
    for _ in range(30):     # Newton on f(c) - VmaxVvir2 = 0
        conec = c / (1.0 + c)
        y = VmaxVvir2 - nfw_f(c)
        dy = 0.216 * conec * conec / torch.clamp_min(c, 1e-6)
        c = torch.clamp(c + y / torch.clamp_min(dy, 1e-12), 1.0, 1000.0)
    rmaxv = torch.clamp_min(props["gRmaxvel"], 1e-30)
    ratio_fallback = torch.where(M200c > 0, R200c / rmaxv, gsize / rmaxv)
    use_newton = (VmaxVvir2 > 1.05) & (VmaxVvir2 <= 36.0)
    props["cNFW"] = torch.where(R200c <= 0, -1.0,
                                torch.where(use_newton, c, ratio_fallback))
    props["VmaxVvir2"] = VmaxVvir2
    props["gsize"] = gsize
    for key, v in props.items():      # zero the untagged row
        v = v.clone()
        v[0] = 0
        props[key] = v
    return props


def compute_aperture_properties(pos, vel, mass, pfof, num_groups: int, *,
                                refpos, refvel, **kw) -> Props:
    """Aperture masses, counts, dispersions and half-mass radii, projected
    aperture masses and radial mass profiles (reference
    CalculateApertureQuantities, substructureproperties.cxx:4539)."""
    pfof, pos, vel, mass = group_sorted(pfof, pos, vel, mass)
    return _apertures(pos, vel, mass, pfof, num_groups, refpos=refpos,
                      refvel=refvel, **kw)


def _apertures(pos, vel, mass, pfof, num_groups: int, *, refpos, refvel,
               apertures: Sequence[float] = (),
               apertures_proj: Sequence[float] = (),
               profile_edges: Sequence[float] = (), iprofilenorm: int = 0,
               R200c: Optional[torch.Tensor] = None) -> Props:
    n = pos.shape[0]
    ng1 = num_groups + 1
    out: Props = {}
    dx = pos - refpos[pfof]
    r2 = seg.sq3(dx)
    ing = pfof > 0

    if apertures:
        # one radius sort serves every aperture's half-mass radius
        perm_r = seg.lexsort2(r2, pfof)
        g_sr = pfof[perm_r]
        r_sr = torch.sqrt(torch.clamp_min(r2[perm_r], 1e-30))
        offs_r = seg.group_offsets(g_sr, num_groups)
        Mcum_r = seg.segment_cumsum(torch.where(g_sr > 0, mass[perm_r], 0.0),
                                    g_sr, offs_r)
    for ai, a in enumerate(apertures):
        sel = ing & (r2 < a * a)
        w = torch.where(sel, mass, 0.0)
        m_ap = _ssum(w, pfof, ng1)
        vm = seg.segment_mean(vel, w, pfof, ng1, presorted=True)
        dv2 = seg.sq3(vel - vm[pfof])
        out[f"Aperture_mass_{ai}"] = m_ap
        out[f"Aperture_npart_{ai}"] = seg.segment_count(sel, pfof, ng1)
        out[f"Aperture_veldisp_{ai}"] = torch.sqrt(torch.clamp_min(
            _ssum(torch.where(sel, dv2 * mass, 0.0), pfof, ng1) /
            torch.clamp_min(m_ap, 1e-30) / 3.0, 0.0))
        # reference aperture_rhalfmass, substructureproperties.cxx:4639
        kh = _first_crossing((Mcum_r >= (0.5 * m_ap)[g_sr]) & (g_sr > 0) &
                             (r_sr < a), g_sr, ng1)
        out[f"Aperture_rhalfmass_{ai}"] = torch.where(
            kh < n, r_sr[torch.clamp(kh, 0, n - 1)], 0.0)

    for ai, a in enumerate(apertures_proj):
        for pi, (i0, i1) in enumerate(((0, 1), (0, 2), (1, 2))):
            rp2 = dx[:, i0] ** 2 + dx[:, i1] ** 2
            out[f"Projected_aperture_{ai}_mass_proj{pi}"] = _ssum(
                torch.where(ing & (rp2 < a * a), mass, 0.0), pfof, ng1)

    if profile_edges:
        edges = torch.tensor(profile_edges, dtype=pos.dtype,
                             device=pos.device)
        r = torch.sqrt(torch.clamp_min(r2, 1e-30))
        if iprofilenorm == 0 and R200c is not None:
            r = r / torch.clamp_min(R200c[pfof], 1e-30)
        ib = torch.searchsorted(edges, torch.log10(torch.clamp_min(r, 1e-30)))
        nb = len(profile_edges) + 1
        # sorted sums and integer counts: no float atomics, so the
        # profile does not change from run to run on a card
        flat = torch.where(ing, pfof * nb + ib, ng1 * nb)
        out["Mass_profile"] = seg.segment_sum(
            mass, flat, ng1 * nb + 1)[:ng1 * nb].view(ng1, nb)
        out["Npart_profile"] = torch.bincount(
            flat, minlength=ng1 * nb + 1)[:ng1 * nb].view(ng1, nb)
    return out


def compute_rvmax_properties(pos, vel, mass, pfof, num_groups: int, *,
                             refpos, refvel, rmax) -> Props:
    """Dispersion tensor, sigma_v, angular momentum and shape within R_Vmax
    (reference RVmax_* fields, substructureproperties.cxx:430-520)."""
    pfof, pos, vel, mass = group_sorted(pfof, pos, vel, mass)
    return _rvmax(pos, vel, mass, pfof, num_groups, refpos=refpos,
                  refvel=refvel, rmax=rmax)


def _rvmax(pos, vel, mass, pfof, num_groups: int, *, refpos, refvel,
           rmax) -> Props:
    ng1 = num_groups + 1
    dx = pos - refpos[pfof]
    dv = vel - refvel[pfof]
    sel = (pfof > 0) & (seg.sq3(dx) < rmax[pfof] ** 2)
    w = torch.where(sel, mass, 0.0)
    msum = torch.clamp_min(_ssum(w, pfof, ng1), 1e-30)[:, None, None]
    vd = seg.segment_outer(dv, dv, w, pfof, ng1, presorted=True) / msum
    iten = seg.segment_outer(dx, dx, w, pfof, ng1, presorted=True) / msum
    q, s, evecs = _eig_shape(iten)
    return {
        "RVmax_veldisp": vd,
        "RVmax_sigV": _sigma(vd),
        "RVmax_L": _ssum(torch.linalg.cross(dx, dv) * w[:, None], pfof, ng1),
        "RVmax_q": q,
        "RVmax_s": s,
        "RVmax_eigvec": evecs,
        "RVmax_npart": seg.segment_count(sel, pfof, ng1),
    }


def compute_energies(vel, mass, pfof, W, num_groups: int, gcmvel,
                     Eratio: float) -> Props:
    """Bound mass fraction and potential / kinetic energy totals per group
    (reference GetBindingEnergy, substructureproperties.cxx:3884)."""
    pfof, vel, mass, W = group_sorted(pfof, vel, mass, W)
    return _energies(vel, mass, pfof, W, num_groups, gcmvel, Eratio)


def _energies(vel, mass, pfof, W, num_groups: int, gcmvel,
              Eratio: float) -> Props:
    ng1 = num_groups + 1
    T = 0.5 * mass * seg.sq3(vel - gcmvel[pfof])
    E = _f(Eratio, T) * T + W
    ing = pfof > 0
    mtot = torch.clamp_min(_ssum(torch.where(ing, mass, 0.0), pfof, ng1),
                           1e-30)
    mbound = _ssum(torch.where(ing & (E < 0), mass, 0.0), pfof, ng1)
    return {
        "Efrac": mbound / mtot,
        "Epot": 0.5 * _ssum(torch.where(ing, W, 0.0), pfof, ng1),
        "Ekin_unbind": _ssum(torch.where(ing, T, 0.0), pfof, ng1),
    }


def property_bundle(opt: C.Options, pos, vel, mass, pfof, num_groups: int,
                    *, W=None, ptype=None, boxsize=None,
                    pertype: bool = False, **extras) -> Props:
    """The property stage as the reference sequences it inside
    GetProperties (substructureproperties.cxx:266+): reference-frame choice
    (``Reference_frame_for_properties``: CM, most bound particle or
    potential minimum, frame selection :327-340), core properties,
    apertures and profiles, the RVmax block and binding energies."""
    if pertype:
        raise NotImplementedError("per-type (baryon) properties are not "
                                  "ported yet")
    ptype = None if ptype is None else torch.as_tensor(ptype,
                                                       device=pos.device)
    pfof, pos, vel, mass, W, ptype = group_sorted(pfof, pos, vel, mass, W,
                                                  ptype)
    ng1 = num_groups + 1
    refpos = refvel = None
    if opt.iPropertyReferencePosition != C.PROPREFCM and W is not None:
        if opt.iPropertyReferencePosition == C.PROPREFMINPOT:
            key = W
        else:       # PROPREFMBP
            wm = torch.where(pfof > 0, mass, 0.0)
            vmean = seg.segment_mean(vel, wm, pfof, ng1, presorted=True)
            key = 0.5 * mass * seg.sq3(vel - vmean[pfof]) + W
        key = torch.where(pfof > 0, key, math.inf)
        if opt.ParticleTypeForRefenceFrame != -1 and ptype is not None:
            key = torch.where(ptype == opt.ParticleTypeForRefenceFrame, key,
                              math.inf)
        ridx = torch.clamp(seg.segment_argmin(key, pfof, ng1), 0,
                           pos.shape[0] - 1)
        refpos, refvel = pos[ridx], vel[ridx]

    pr = _properties(
        pos, vel, mass, pfof, num_groups,
        G=opt.G, boxsize=boxsize, rhocrit=opt.rhocrit, rhobg=opt.rhobg,
        virlevel=opt.virlevel if opt.virlevel > 0 else 200.0,
        virBN98=opt.virBN98,
        so_thresholds=tuple(opt.SOthresholds_values_crit),
        min_size=opt.MinSize, iIterateCM=bool(opt.iIterateCM),
        cmfrac=opt.pinfo.cmfrac, cmadjustfac=opt.pinfo.cmadjustfac,
        refpos=refpos)
    # centre of every radius-dependent stage below (the reference
    # re-references all positions to cmref up front, :320-340)
    ref_c = refpos if refpos is not None else pr["gcm"]
    if opt.iaperturecalc or opt.iprofilecalc:
        to_int = 1.0 / opt.lengthtokpc if opt.lengthtokpc > 0 else 1.0
        aps = tuple(a * to_int for a in opt.aperture_values_kpc) \
            if opt.iaperturecalc else ()
        aps_proj = tuple(a * to_int for a in opt.aperture_proj_values_kpc) \
            if opt.iaperturecalc else ()
        edges = tuple(opt.profile_bin_edges) if opt.iprofilecalc else ()
        pr.update(_apertures(
            pos, vel, mass, pfof, num_groups, refpos=ref_c,
            refvel=pr["gcmvel"], apertures=aps, apertures_proj=aps_proj,
            profile_edges=edges, iprofilenorm=opt.iprofilenorm,
            R200c=pr["gR200c"]))
    if opt.iextrahalooutput:
        pr.update(_rvmax(pos, vel, mass, pfof, num_groups, refpos=ref_c,
                         refvel=pr["gcmvel"], rmax=pr["gRmaxvel"]))
    if W is not None:
        pr.update(_energies(vel, mass, pfof, W, num_groups, pr["gcmvel"],
                            opt.uinfo.Eratio))
    return pr
