"""The port's all-particle spherical overdensities
(velociraptor_stf_tpu_torch/ops/so.py) against the JAX package's
ops/so.py on the same numpy inputs, and against the analytic case of
tests/test_so.py.

Tolerances: SO masses and radii within rtol 2e-3 (the golden property
tolerance, tests/test_golden_writers.py:204-205; the binned masses are
float32 sums in another order); SO particle lists exact (offsets, and the
particle indices in their radius order).
"""

import math

import numpy as np
import pytest
import torch

from velociraptor_stf_tpu.ops import so as JSO

from velociraptor_stf_tpu_torch.ops import so as TSO

BOX = 20.0
# (centre, radius, members): four octave classes of search radius; the
# third halo straddles the periodic boundary
HALOS = [((5.0, 5.0, 5.0), 1.0, 8000), ((15.0, 15.0, 15.0), 0.1, 2000),
         ((0.3, 10.0, 19.8), 0.5, 4000), ((10.0, 10.0, 10.0), 0.25, 3000)]
RSEARCH = np.array([4.0, 0.4, 2.0, 1.0])


@pytest.fixture(scope="module")
def halo_field():
    rng = np.random.default_rng(3)
    parts = [rng.random((20000, 3)) * BOX]
    for c, rh, n in HALOS:
        r = rh * rng.random(n) ** 1.5
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        parts.append(np.asarray(c) + d * r[:, None])
    pos = np.mod(np.concatenate(parts), BOX).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, len(pos)).astype(np.float32)
    centres = np.array([c for c, _, _ in HALOS], np.float32)
    rho = mass.sum() / BOX ** 3
    lnthr = [math.log(f * rho) for f in (100.0, 500.0, 2000.0, 1e4)]
    return pos, mass, centres, lnthr


@pytest.mark.parametrize("boxsize", [BOX, None], ids=["periodic", "open"])
def test_so_masses_match_reference(halo_field, boxsize):
    pos, mass, centres, lnthr = halo_field
    kw = dict(boxsize=boxsize, minnum=np.array([8, 8, 20, 8]),
              first_mass=np.full(4, float(mass.min())))
    Mw, Rw = JSO.so_masses_all_particles(pos, mass, centres, RSEARCH, lnthr,
                                         **kw)
    Mg, Rg = TSO.so_masses_all_particles(torch.from_numpy(pos),
                                         torch.from_numpy(mass), centres,
                                         RSEARCH, lnthr, **kw)
    assert (Mw > 0).sum() >= 10           # most crossings found
    np.testing.assert_allclose(Mg, Mw, rtol=2e-3, atol=0)
    np.testing.assert_allclose(Rg, Rw, rtol=2e-3, atol=0)


@pytest.mark.parametrize("boxsize", [BOX, None], ids=["periodic", "open"])
def test_so_particle_list_matches_reference(halo_field, boxsize):
    pos, _, centres, _ = halo_field
    rmax = np.array([1.0, 0.2, 0.6, 0.3])
    offs_w, idx_w = JSO.so_particle_list(pos, centres, rmax,
                                         boxsize=boxsize)
    offs_g, idx_g = TSO.so_particle_list(torch.from_numpy(pos), centres,
                                         rmax, boxsize=boxsize)
    np.testing.assert_array_equal(offs_g, offs_w)
    np.testing.assert_array_equal(idx_g, idx_w)
    assert offs_g[-1] > 10000


def test_so_search_radii_match_reference():
    rng = np.random.default_rng(5)
    gmass = rng.uniform(10, 1e4, 50)
    gsize = rng.uniform(0.05, 2.0, 50)
    np.testing.assert_array_equal(
        TSO.so_search_radii(gmass, gsize, math.log(50.0), 2.5),
        JSO.so_search_radii(gmass, gsize, math.log(50.0), 2.5))


def test_so_all_particles_matches_analytic():
    """tests/test_so.py:33-48: M(<r) ~ r halo in a uniform background."""
    rng = np.random.default_rng(1)
    n_h, n_bg, boxsize, Rh = 20000, 40000, 10.0, 0.5
    centre = np.array([5.0, 5.0, 5.0])
    r = Rh * rng.random(n_h)
    d = rng.normal(size=(n_h, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.concatenate([centre + d * r[:, None],
                          rng.random((n_bg, 3)) * boxsize]).astype(
                              np.float32)
    mass = np.ones(len(pos), np.float32)
    rt = 0.35
    vol = 4 / 3 * math.pi * rt ** 3
    M_true = n_h * rt / Rh + vol * n_bg / boxsize ** 3
    M, R = TSO.so_masses_all_particles(
        torch.from_numpy(pos), torch.from_numpy(mass), centre[None, :],
        np.array([2.0]), [math.log(M_true / vol)], boxsize=boxsize,
        minnum=np.array([8]), first_mass=np.array([1.0]))
    assert R[0, 0] == pytest.approx(rt, rel=0.03)
    assert M[0, 0] == pytest.approx(M_true, rel=0.04)


def test_candidate_chunks_keep_slot_order():
    """Chunked expansion yields the reference's flat slot order whatever
    the budget, windows of length 0 included."""
    pst = torch.tensor([[3, 0, 9], [0, 5, 1]])
    pcn = torch.tensor([[2, 0, 3], [4, 1, 0]])
    want_row = [0, 0, 0, 0, 0, 1, 1, 1, 1, 1]
    want_col = [3, 4, 9, 10, 11, 0, 1, 2, 3, 5]
    for budget in (1, 2, 3, 5, 100):
        parts = list(TSO.flat_candidates(pst, pcn, budget))
        assert torch.cat([r for r, _ in parts]).tolist() == want_row
        assert torch.cat([c for _, c in parts]).tolist() == want_col
