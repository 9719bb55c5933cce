"""Single-halo mode (``Singlehalo_search``, ``iSingleHalo``) and the
linking-length scaling (``iScaleLengths``, models/haloprops.py) of the
port against the JAX package's on tests/test_options.py:170's halo: the
scaled lengths equal, and the catalog's ids, hierarchy and properties as
find_structures' other gates hold them.
"""

import numpy as np
import pytest

from velociraptor_stf_tpu.models import haloprops as JH
from velociraptor_stf_tpu.models import pipeline as JP
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import haloprops as TH
from velociraptor_stf_tpu_torch.models import pipeline as TP

from test_torch_properties import assert_props_match
from torch_threads import one_torch_thread  # noqa: F401


def _halo(n=20000):
    """tests/test_options.py:170's halo."""
    rng = np.random.default_rng(46)
    r = 0.5 / np.sqrt(rng.uniform(0.05, 1.0, n) ** (-2 / 3) - 1.0 + 1e-9)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = (r[:, None] * u + 5.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    return pos, vel, np.full(n, 0.05, np.float32)


def _opts(**over):
    opt = C.Options()
    opt.G = 43.0211349
    opt.virlevel = 200.0
    opt.iSingleHalo = 1
    opt.iScaleLengths = 1
    opt.iSubSearch = 0
    opt.MinSize = 20
    opt.uinfo.unbindflag = 0
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _same_catalog(got, want):
    assert got.ngroups == want.ngroups
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    for k in ("parent", "hostid", "hierarchy_level"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    assert_props_match(got.props, want.props, got.ngroups)


def test_scale_linking_lengths_matches_reference():
    pos, vel, mass = _halo()
    jopt = _opts()
    topt = convert.options(jopt)
    JH.scale_linking_lengths(jopt, pos, vel, mass)
    TH.scale_linking_lengths(topt, pos, vel, mass)
    assert (topt.ellxscale, topt.ellvscale) == (jopt.ellxscale,
                                                 jopt.ellvscale)
    for g, w in zip(TH.adjust_to_cm(pos, vel, mass),
                    JH.adjust_to_cm(pos, vel, mass)):
        np.testing.assert_array_equal(g, w)


def test_single_halo_scaled_matches_reference():
    """The halo as group 1 with its lengths scaled (the scaling mutates
    the options, as the reference's does)."""
    pos, vel, mass = _halo()
    jopt = _opts()
    topt = convert.options(jopt)
    want = JP.find_structures(jopt, pos, vel, mass)
    got = TP.find_structures(topt, pos, vel, mass, device="cpu")
    assert topt.ellxscale == jopt.ellxscale != C.Options().ellxscale
    _same_catalog(got, want)
    assert got.ngroups == 1 and (got.pfof == 1).all()


@pytest.mark.parametrize("unbind", [0, 1])
def test_single_halo_substructure_matches_reference(unbind):
    """The planted host and subhalo of tests/test_substructure.py as the
    single halo, searched for substructure (and unbound)."""
    from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS,
                                                         host_with_subhalo)

    pos, vel, mass, member = host_with_subhalo(seed=1, nhost=4000,
                                               nsub=500)
    jopt = _opts(iScaleLengths=0, iSubSearch=1, iiterflag=1, ellphys=0.2,
                 ellxscale=0.25, ellthreshold=2.5, Vratio=2.0,
                 thetaopen=0.1, G=G_KMS, iBoundHalos=unbind)
    jopt.uinfo.unbindflag = unbind
    # a softening: with eps = 0 the JAX package's potential of a group's
    # last member is NaN (its tile padding copies sit on it)
    jopt.uinfo.eps = 1e-3
    want = JP.find_structures(jopt, pos, vel, mass)
    got = TP.find_structures(convert.options(jopt), pos, vel, mass,
                             device="cpu")
    _same_catalog(got, want)
    assert got.ngroups >= 2 and got.parent[2] == 1
    assert (got.pfof[member] >= 2).mean() > 0.5
