"""Spherical overdensities of spheres larger than the periodic box (ROADMAP
queue 3, F3), pinned against the JAX package.

Without units the overdensity thresholds are never crossed inside the box
(R200c = 946 for group 2 in a box of 32), so both packages extrapolate the
enclosed-density profile and search a sphere wider than the box.  A cell
grid at least one search radius wide then has one cell per axis, the nine
(x, y) columns of the 27-cell stencil are the same column, and every
particle enters each such list nine times, in both packages.  The input is
outside what either code is meant for (a minimum image needs R < box / 2),
so these tests pin the behaviour instead of repairing it: ids and list
offsets equal; lists equal as multisets, and in order wherever the sphere
fits in half the box (within a list, equal float32 radii of different
particles keep the candidate order, which differs); extrapolated masses
within 5e-3, all other groups within the golden tolerance.
"""

import numpy as np
import pytest

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import pipeline as JP

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import pipeline as TP

from test_torch_slice import _bench_opts
from torch_threads import one_torch_thread  # noqa: F401

BOX, N = 32.0, 1 << 15


@pytest.fixture(scope="module")
def mock():
    return make_cosmo_mock(N, boxsize=BOX, nhalos=60, seed=9)


def _runs(mock, **over):
    pos, vel, mass = mock
    opt = _bench_opts(BOX, N, **over)
    want = JP.find_structures(opt, pos, vel, mass, boxsize=BOX)
    got = TP.find_structures(convert.options(opt), pos, vel, mass,
                             boxsize=BOX, device="cpu")
    assert got.ngroups == want.ngroups
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    return got, want


def test_so_list_of_sphere_wider_than_box(mock):
    got, want = _runs(mock, iKeepFOF=1, iInclusiveHalo=3,
                      iSphericalOverdensityPartList=1)
    offs = np.asarray(want.so_offsets)
    np.testing.assert_array_equal(got.so_offsets, offs)
    rmax = np.max(np.stack([np.asarray(want.props[k]) for k in (
        "gRvir", "gR200c", "gR200m", "gR500c", "gRBN98")]), 0)
    wide = 0
    for g in range(1, want.ngroups + 1):
        a = got.so_indices[offs[g - 1]:offs[g]]
        b = np.asarray(want.so_indices)[offs[g - 1]:offs[g]]
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
        if rmax[g] <= BOX / 2:
            np.testing.assert_array_equal(a, b)
        elif len(a):
            wide += 1
            # a one-cell grid: each particle once per (x, y) column
            _, counts = np.unique(a, return_counts=True)
            assert (counts == 9).all()
    assert wide >= 1


def test_so_masses_of_sphere_wider_than_box(mock):
    got, want = _runs(mock, iBoundHalos=0, iInclusiveHalo=3)
    ng = got.ngroups
    for mk, rk in (("gM200c", "gR200c"), ("gM500c", "gR500c"),
                   ("gMvir", "gRvir")):
        r = np.asarray(want.props[rk])[1:ng + 1]
        wide = r > BOX / 2
        assert wide.any()
        for k, rtol in ((mk, 5e-3), (rk, 2e-3)):
            g = got.props[k][1:ng + 1]
            w = np.asarray(want.props[k])[1:ng + 1]
            np.testing.assert_allclose(g[wide], w[wide], rtol=rtol,
                                       err_msg=k)
            np.testing.assert_allclose(g[~wide], w[~wide], rtol=2e-3,
                                       err_msg=k)
