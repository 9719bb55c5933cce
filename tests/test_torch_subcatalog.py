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


def assert_props_inside(got, want, ng):
    """assert_props_match, with the spherical-overdensity values taken
    apart.  Where a sphere reaches beyond the group's particles (R >
    gsize) both packages extrapolate the enclosed-density profile, which
    amplifies the rounding of the cumulative masses without bound: such a
    value must extrapolate too and be finite and positive.  Elsewhere the
    SO values are held to rtol 1e-2: a host with its substructure carved
    out has a shallow, ragged enclosed-density profile at the crossing,
    where the reference's float32 prefix sum of the masses and the port's
    float64 one (ROADMAP queue 3) move the interpolated crossing by up to
    0.5%."""
    got = {k: np.array(v) for k, v in got.items()}
    want = {k: np.array(v) for k, v in want.items()}
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
                assert np.isfinite(g[out]).all() and (g[out] > 0).all(), k
                np.testing.assert_allclose(g[~out], w[~out], rtol=1e-2,
                                           err_msg=k)
                g[:] = w
    assert_props_match(got, want, ng)


def assert_same_catalog(got, want, w_rtol=1e-4):
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
    assert_props_inside(got.props, want.props, got.ngroups)


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
    assert_same_catalog(got, want)
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
    assert_same_catalog(got, want)
    assert (got.parent > 0).sum() >= 1
    assert (got.pfof[ptype == 0] > 0).any()
    assert "baryons" in got.timings and "substructure" in got.timings
