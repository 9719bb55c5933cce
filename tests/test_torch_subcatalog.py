"""The port's find_structures with the substructure search on
(``iSubSearch = 1``) against the JAX package's: planted hosts with
subhalos in a periodic box, with the field halos unbound once
(``Bound_halos = 1``) or again after their substructures are carved out
(``Bound_halos = 2``), and a hydro mock with the baryon search, where
unequal masses reach the outlier histograms.  Exact: group ids, group
count, hostid, parent and level; properties within the golden tolerance
(tests/test_torch_properties.py::assert_props_match); potentials within
rel 1e-4.
"""

import numpy as np
import pytest

from velociraptor_stf_tpu.models import pipeline as JP
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import G_KMS, planted_subhalos
from velociraptor_stf_tpu_torch.models import pipeline as TP

from test_torch_properties import assert_props_match
from torch_threads import one_torch_thread  # noqa: F401

BOX = 16.0


def planted_options(**over):
    """FOF3D field halos (each planted host one group), the substructure
    options of tests/test_substructure.py, unbinding on."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale, opt.ellhalophysfac = 0.2, 0.25, 4.0
    opt.fofbgtype = C.FOF3D
    opt.MinSize = opt.HaloMinSize = 20
    opt.iSubSearch, opt.iiterflag = 1, 1
    opt.ellthreshold, opt.Vratio, opt.thetaopen, opt.ellfac = \
        2.5, 2.0, 0.10, 1.0
    opt.uinfo.unbindflag = 1
    opt.uinfo.Eratio = 1.0
    opt.iBoundHalos = 1
    opt.G = G_KMS
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


SO_PAIRS = (("gMvir", "gRvir"), ("gM200c", "gR200c"), ("gM200m", "gR200m"),
            ("gM500c", "gR500c"), ("gMBN98", "gRBN98"),
            ("SO_mass", "SO_radius"))


def _group_radii(pos, centre, members, boxsize=None):
    """float64 radii of ``members`` about ``centre`` as the property stage
    takes them, at least 1e-15: with ``boxsize``, of the positions mapped
    to the nearest image of the group's first member (the core
    properties' unwrapping, ``ops/segments.py::unwrap_positions``), else
    of the positions as they are (the apertures, profiles and per-type
    blocks)."""
    x = pos[members].astype(np.float64)
    if boxsize:
        d = x - x[0]
        x = x[0] + d - boxsize * np.round(d / boxsize)
    dx = x - centre
    return np.sqrt(np.maximum((dx * dx).sum(1), 1e-30))


def _crossing(r, m, eligible, half, strict=True):
    """(exact, lo, hi) radius-sorted rows among ``eligible`` ones: where
    the cumulative mass ``m`` first exceeds (``strict``) or reaches
    ``half``, where it first reaches ``half`` less one float32 ulp of it
    and where it first exceeds it by one ulp; -1 where none does.
    lo == hi unless the cumulative mass lies within an ulp of ``half``
    (a tie)."""
    c = np.cumsum(m)
    e = float(np.spacing(np.float32(half)))

    def first(cond):
        k = np.nonzero(eligible & cond)[0]
        return k[0] if len(k) else -1
    return (first(c > half if strict else c >= half), first(c >= half - e),
            first(c > half + e if strict else c >= half + e))


def half_mass_ties(opt, want, pos, mass, pfof, *, W=None, vel=None,
                   ptype=None, sfr=None, boxsize=None, got=None):
    """F5's rule (ROADMAP queue 3): the groups where a half-mass radius
    falls on a tie of the cumulative mass, found by a float64 numpy
    oracle, and the values accepted there.

    Where some cumulative mass lies within one float32 ulp of the half
    mass (gRhalfmass), of an aperture's (Aperture_rhalfmass_<i>) or of a
    type's (R_HalfMass_<t>), the port, which compares its float64
    per-group sums (``models/properties.py::_above_half``), must give the
    oracle's radius: the first where the cumulative mass exceeds half
    (reaches it, for an aperture).  The JAX package subtracts from one
    float32 cumsum over all rows, so its crossing may land on the radius
    of the tied row or of the next one of the type (or on a row of
    another type between them, whose zero mass still moves XLA's
    rounding of the cumsum): any radius from the one to the other is
    accepted, and with it the mass within twice that radius
    (gMassTwiceRhalfmass, MassTwiceRhalfmass_<t>).  Radii are taken
    about the reference frame of ``opt.iPropertyReferencePosition``: the
    catalog's gcm, or the member of lowest potential (``W``) or energy
    (``vel``).  Returns {key: (tied (ng+1,) bool, accepted (ng+1, 3)
    float64: the port's value, then the bounds of the reference's)} for
    the keys of ``want``; pfof, pos, mass, W, vel, ptype and sfr are per
    particle, in one order.

    Radial profiles normalised by R200c (``Radial_profile_norm=0``) are
    built on an SO radius, which the two packages' cumulative sums move
    (assert_props_inside's SO rule): with ``got``, at the groups where
    the oracle's binnings of the members by the two catalogs' radii
    differ (a member lies between a bin edge scaled by the one and by
    the other), each catalog's Npart_profile and Mass_profile must be
    the oracle's binning by its own radius (the entries hold (ng+1, 2,
    nbins): the port's, the reference's).  Every other group's profiles
    are compared directly."""
    ng = len(np.asarray(want["gmass"])) - 1
    pfof = np.asarray(pfof, np.int64)
    mass = np.asarray(mass, np.float64)
    order = np.argsort(pfof, kind="stable")
    bounds = np.searchsorted(pfof[order], np.arange(ng + 2))
    keys = {"gRhalfmass": "gMassTwiceRhalfmass"}
    to_int = 1.0 / opt.lengthtokpc if opt.lengthtokpc > 0 else 1.0
    aps = [a * to_int for a in opt.aperture_values_kpc] \
        if opt.iaperturecalc else []
    keys.update({f"Aperture_rhalfmass_{i}": None for i in range(len(aps))})
    types = []
    if ptype is not None:
        ptype = np.asarray(ptype)
        for t, code in (("gas", 0), ("star", 4), ("bh", 5)):
            types.append((t, ptype == code))
            if t == "gas" and sfr is not None:
                types += [("gas_sf", (ptype == 0) & (sfr > 0)),
                          ("gas_nsf", (ptype == 0) & (sfr <= 0))]
        keys.update({f"R_HalfMass_{t}": f"MassTwiceRhalfmass_{t}"
                     for t, _ in types})
    keys = {k: v for k, v in keys.items() if k in want}
    out = {k: (np.zeros(ng + 1, bool), np.zeros((ng + 1, 3)))
           for k in list(keys) + [v for v in keys.values() if v in want]}
    gcm = np.asarray(want["gcm"], np.float64)
    norm = None
    if got is not None and "Npart_profile" in want and opt.iprofilenorm == 0:
        rkey = "gR200c_excl" if "gR200c_excl" in want else "gR200c"
        norm = np.stack([np.asarray(got[rkey], np.float64),
                         np.asarray(want[rkey], np.float64)], 1)[:ng + 1]
        edges = np.asarray(opt.profile_bin_edges, np.float64)
        nb = len(edges) + 1
        for k in ("Npart_profile", "Mass_profile"):
            out[k] = (np.zeros(ng + 1, bool), np.zeros((ng + 1, 2, nb)))
    for g in range(1, ng + 1):
        mem = order[bounds[g]:bounds[g + 1]]
        if len(mem) == 0:
            continue
        centre = gcm[g]
        if opt.iPropertyReferencePosition != 0 and W is not None:
            key = np.asarray(W, np.float64)[mem]
            if opt.iPropertyReferencePosition == 1:     # most bound
                v = np.asarray(vel, np.float64)[mem]
                dv = v - (mass[mem, None] * v).sum(0) / mass[mem].sum()
                key = key + 0.5 * mass[mem] * (dv * dv).sum(1)
            if opt.ParticleTypeForRefenceFrame != -1 and ptype is not None:
                key = np.where(ptype[mem] == opt.ParticleTypeForRefenceFrame,
                               key, np.inf)
            centre = pos[mem[np.argmin(key)]].astype(np.float64)
        r0 = _group_radii(pos, centre, mem, boxsize)
        r = _group_radii(pos, centre, mem)
        if norm is not None and norm[g, 0] != norm[g, 1]:
            ib = [np.searchsorted(edges, np.log10(np.maximum(
                r / max(norm[g, side], 1e-30), 1e-30))) for side in range(2)]
            if (ib[0] != ib[1]).any():
                for side in range(2):
                    out["Npart_profile"][1][g, side] = np.bincount(
                        ib[side], minlength=nb)
                    out["Mass_profile"][1][g, side] = np.bincount(
                        ib[side], weights=mass[mem], minlength=nb)
                out["Npart_profile"][0][g] = out["Mass_profile"][0][g] = True
        every = np.ones(len(mem), bool)
        cases = [("gRhalfmass", r0, every, True)]
        cases += [(f"Aperture_rhalfmass_{i}", r, r < a, False)
                  for i, a in enumerate(aps)]
        cases += [(f"R_HalfMass_{t}", r, sel[mem], True) for t, sel in types]
        for key, rad, sel, strict in cases:
            if key not in keys:
                continue
            srt = np.argsort(rad, kind="stable")
            r, sel = rad[srt], sel[srt]
            eligible = sel if key.startswith("Aperture") else every
            mk = np.where(sel, mass[mem][srt], 0.0)
            total = mk[eligible].sum()
            if total <= 0:
                continue
            rows = _crossing(r, mk, eligible, 0.5 * total, strict)
            if min(rows) < 0 or rows[1] == rows[2]:
                continue
            out[key][0][g] = True
            out[key][1][g] = r[list(rows)]
            twice = keys[key]
            if twice in out:
                out[twice][0][g] = True
                out[twice][1][g] = [mk[r <= 2 * r[k]].sum() for k in rows]
    return out


def accept_ties(got, want, ties, rtol=2e-3):
    """At the tied rows of ``ties`` the port must hold its accepted value
    and the reference one within its bounds (profiles: its own binning);
    ``got`` then takes ``want``'s value there."""
    for k, (tied, acc) in ties.items():
        acc = acc[tied]
        port = got[k][tied].astype(np.float64)
        ref = want[k][tied].astype(np.float64)
        if acc.ndim > 2:                               # profiles
            ok = [np.isclose(port, acc[:, 0], rtol=rtol, atol=0),
                  np.isclose(ref, acc[:, 1], rtol=rtol, atol=0)]
            ok = [o.all(1) for o in ok]
        else:
            ok = [np.isclose(port, acc[:, 0], rtol=rtol, atol=0),
                  (ref >= acc[:, 1] * (1 - rtol)) &
                  (ref <= acc[:, 2] * (1 + rtol))]
        for name, o, v in (("port", ok[0], port), ("reference", ok[1], ref)):
            assert o.all(), (k, name, np.nonzero(tied)[0][~o], v[~o],
                             acc[~o])
        got[k][tied] = want[k][tied]


def assert_props_inside(got, want, ng, ties=None, overflow=None):
    """assert_props_match, with the spherical-overdensity values taken
    apart.  Where a sphere reaches beyond the group's particles (R >
    gsize) both packages extrapolate the enclosed-density profile, which
    amplifies the rounding of the cumulative masses without bound: such a
    value must extrapolate too and be finite and positive.  Elsewhere the
    SO values are held to rtol 1e-2: a host with its substructure carved
    out has a shallow, ragged enclosed-density profile at the crossing,
    where the reference's float32 prefix sum of the masses and the port's
    float64 one (ROADMAP queue 3) move the interpolated crossing by up to
    0.5%.  ``ties`` (``half_mass_ties``): at a tie of the cumulative mass
    the half-mass radii and what is built on them take the accepted
    values; every other row is held as before.  ``overflow``
    ({key: cells}, from a float64 oracle of the extrapolation): the cells
    whose extrapolated value lies beyond float32's range, where both
    catalogs must hold inf instead."""
    got = {k: np.array(v) for k, v in got.items()}
    want = {k: np.array(v) for k, v in want.items()}
    if ties:
        accept_ties(got, want, ties)
    size = want["gsize"][:ng + 1]
    for mk, rk in SO_PAIRS:
        for sfx in ("", "_excl"):
            if rk + sfx not in want:
                continue
            r = want[rk + sfx][:ng + 1]
            lim = np.broadcast_to(size if r.ndim == 1 else size[:, None],
                                  r.shape)
            out = r > lim
            assert (got[rk + sfx][:ng + 1][out] > lim[out]).all()
            for k in (mk + sfx, rk + sfx):
                w, g = want[k][:ng + 1], got[k][:ng + 1]
                inf = np.zeros(r.shape, bool) if overflow is None else \
                    overflow.get(k, np.zeros(r.shape, bool))[:ng + 1]
                assert (out[inf] & np.isposinf(w[inf]) &
                        np.isposinf(g[inf])).all(), k
                fin = out & ~inf
                assert np.isfinite(g[fin]).all() and (g[fin] > 0).all(), k
                np.testing.assert_allclose(g[~out], w[~out], rtol=1e-2,
                                           err_msg=k)
                g[:] = w
    assert_props_match(got, want, ng)


def assert_same_catalog(got, want, w_rtol=1e-4, opt=None, pos=None,
                        mass=None, ptype=None):
    """Ids, hierarchy and potentials; properties within
    assert_props_inside, with F5's rule from ``half_mass_ties`` on the
    particles ``pos``, ``mass`` (``ptype``) of ``opt``'s run."""
    assert got.ngroups == want.ngroups
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    for k in ("hostid", "parent", "hierarchy_level", "stype"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    if want.W is not None:
        w = np.asarray(want.W)
        np.testing.assert_allclose(got.W, w, rtol=w_rtol,
                                   atol=w_rtol * np.abs(w).max())
    ties = None if opt is None else half_mass_ties(
        opt, want.props, pos, mass, got.pfof, W=want.W, ptype=ptype,
        boxsize=BOX)
    assert_props_inside(got.props, want.props, got.ngroups, ties=ties)


@pytest.mark.parametrize("case", ["bound1", "bound2", "keepfof"])
def test_planted_subhalos_match_reference(case):
    """Bound_halos 1 and 2, and 6DFOF halos inside kept 3DFOF envelopes
    (iKeepFOF), whose substructure sits one level deeper."""
    pos, vel, mass, host = planted_subhalos(3, seed=3, offset=4.0)
    opt = planted_options(**{"bound1": dict(iBoundHalos=1),
                             "bound2": dict(iBoundHalos=2),
                             "keepfof": dict(fofbgtype=C.FOF6D,
                                             iKeepFOF=1)}[case])
    want = JP.find_structures(opt, pos, vel, mass, boxsize=BOX)
    got = TP.find_structures(convert.options(opt), pos, vel, mass,
                             boxsize=BOX, device="cpu")
    assert_same_catalog(got, want, opt=opt, pos=pos, mass=mass)
    if case == "keepfof":
        env = got.stype == C.FOF3DTYPE
        subs = np.nonzero((got.parent > 0) & ~env &
                          (got.hierarchy_level == 2))[0]
    else:
        subs = np.nonzero(got.parent > 0)[0]
        assert (got.hierarchy_level[subs] == 1).all()
        assert {"fof", "unbind", "substructure", "properties"} <= \
            set(got.timings)
    assert len(subs) >= 2
    # every substructure sits inside its host's planted halo
    for g in subs:
        hosts = np.unique(host[got.pfof == g])
        assert len(hosts) == 1


def test_hydro_substructure_matches_reference():
    """Every 6th particle gas (0.6 of the DM mass): the DM search and its
    substructure, the baryons' association, and the combined unbind that
    renumbers the hierarchy."""
    pos, vel, mass, _ = planted_subhalos(3, seed=3, offset=4.0)
    ptype = np.where(np.arange(len(pos)) % 6 == 5, 0, 1).astype(np.int32)
    mass = np.where(ptype == 0, 0.6 * mass, mass).astype(np.float32)
    opt = planted_options(iBaryonSearch=1, partsearchtype=C.PSTALL)
    want = JP.find_structures(opt, pos, vel, mass, boxsize=BOX, ptype=ptype)
    got = TP.find_structures(convert.options(opt), pos, vel, mass,
                             boxsize=BOX, ptype=ptype, device="cpu")
    assert_same_catalog(got, want, opt=opt, pos=pos, mass=mass, ptype=ptype)
    assert (got.parent > 0).sum() >= 1
    assert (got.pfof[ptype == 0] > 0).any()
    assert "baryons" in got.timings and "substructure" in got.timings
