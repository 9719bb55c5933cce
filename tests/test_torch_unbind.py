"""The port's unbinding (velociraptor_stf_tpu_torch/models/unbind.py)
against the JAX package and brute force, on the same numpy inputs.

Potentials: rel < 1e-4 (the tolerance of test_pallas_interpret.py).  On the
CPU the JAX package sums groups of up to 4096 members directly (above that
it takes an approximate tree), so potential tests keep groups that small.
Ejection: with the SAME W given to both sides, bound masks, group ids, the
old->new id map and the group count are exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import halos as jhalos
from velociraptor_stf_tpu.models import unbind as JU
from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.utils.config import (POTREF, USYSANDPART,
                                               UnbindInfo)
from velociraptor_stf_tpu.validation import oracles

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import unbind as TU
from velociraptor_stf_tpu_torch.ops import segments as tseg
from torch_threads import one_torch_thread  # noqa: F401

G = 43.0211349


def _t(a):
    return torch.from_numpy(np.array(a))


def brute_potential(pos, mass, eps=0.0):
    """f64 W_i / m_i (tests/test_unbind.py)."""
    d = pos[:, None, :] - pos[None, :, :]
    d2 = (d ** 2).sum(-1) + eps ** 2
    inv = 1.0 / np.sqrt(np.where(d2 > 0, d2, 1.0))
    np.fill_diagonal(inv, 0.0)
    return -G * (mass[None, :] * inv).sum(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nz = want != 0
    assert np.array_equal(got[~nz], want[~nz])
    return float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])))


def test_potential_single_group_bruteforce():
    rng = np.random.default_rng(0)
    n = 300
    pos = rng.normal(0, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    W = TU.compute_potential(_t(pos), _t(mass),
                             torch.ones(n, dtype=torch.int64), 1, eps=1e-3,
                             G=G).numpy()
    want = brute_potential(pos.astype(np.float64), mass.astype(np.float64),
                           eps=1e-3) * mass
    assert _rel(W, want) < 1e-4


def test_potential_multigroup_bruteforce():
    """Groups are independent (tests/test_unbind.py:35)."""
    rng = np.random.default_rng(1)
    ns = [50, 211, 700]
    pos = np.concatenate([rng.normal(10 * i, 1, (k, 3))
                          for i, k in enumerate(ns)]).astype(np.float32)
    mass = rng.uniform(0.5, 2, sum(ns)).astype(np.float32)
    pfof = np.concatenate([np.full(k, i + 1) for i, k in enumerate(ns)])
    perm = rng.permutation(len(pos))
    pos, mass, pfof = pos[perm], mass[perm], pfof[perm]
    W = TU.compute_potential(_t(pos), _t(mass), _t(pfof), 3, eps=1e-3,
                             G=G).numpy()
    for g in range(1, 4):
        m_ = pfof == g
        want = brute_potential(pos[m_].astype(np.float64),
                               mass[m_].astype(np.float64), eps=1e-3)
        assert _rel(W[m_] / mass[m_], want) < 1e-4, g


@pytest.fixture(scope="module")
def mock_groups():
    """3DFOF groups of a periodic cosmo mock (the JAX search), groups above
    4096 members untagged."""
    boxsize = 25.0
    n = 1 << 14
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=12, seed=5)
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF3D
    opt.MinSize = 20
    opt.HaloMinSize = 20
    C.config_check(opt)
    r = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(mass), boxsize=boxsize)
    pfof = np.asarray(r.pfof).astype(np.int64)
    sizes = np.bincount(pfof)
    pfof[sizes[pfof] > 4096] = 0
    assert (pfof > 0).sum() > 1000
    return pos, vel, mass, pfof, r.ngroups, boxsize


@pytest.mark.parametrize("eps", [0.0, 0.01])
def test_potential_matches_reference(mock_groups, eps):
    pos, _, mass, pfof, ng, boxsize = mock_groups
    want = np.asarray(JU.compute_potential(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(pfof, jnp.int32),
        ng, eps, G, boxsize=boxsize))
    got = TU.compute_potential(_t(pos), _t(mass), _t(pfof), ng, eps, G,
                               boxsize=boxsize).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) < 1e-4


def test_potential_coincident_particles_eps0():
    """No softening by default: coincident members give -inf, as in the
    reference."""
    pos = np.zeros((4, 3), np.float32)
    pos[2:] = [[1.0, 0, 0], [0, 1.0, 0]]
    mass = np.ones(4, np.float32)
    pfof = np.array([1, 1, 1, 1])
    want = np.asarray(JU.compute_potential(pos, mass, pfof, 1, 0.0, G))
    got = TU.compute_potential(_t(pos), _t(mass), _t(pfof), 1, 0.0,
                               G).numpy()
    assert np.isneginf(got[:2]).all() and np.isneginf(want[:2]).all()
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-6)


def _bound_system(rng, n, centre, radius=0.5, mtot=100.0, vfac=0.3):
    r = radius * rng.uniform(size=n) ** (1 / 3)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = centre + r[:, None] * d
    sigma = vfac * np.sqrt(G * mtot / radius)
    vel = rng.normal(0, sigma / np.sqrt(3), (n, 3))
    return pos, vel, np.full(n, mtot / n)


def _multi(rng, specs, n_bg=0, boxsize=None):
    """Groups ``specs`` = [(gid, n members, unbound fraction, vfac)] at
    separate centres, plus ``n_bg`` untagged particles; shuffled."""
    ps, vs, ms, gs = [], [], [], []
    for k, (gid, n, funb, vfac) in enumerate(specs):
        p, v, m = _bound_system(rng, n, np.array([3.0 + 4 * k, 5.0, 5.0]),
                                vfac=vfac)
        nu = int(funb * n)
        v[:nu] = rng.normal(0, 3000.0, (nu, 3))
        ps.append(p)
        vs.append(v)
        ms.append(m)
        gs.append(np.full(n, gid))
    if n_bg:
        ps.append(rng.uniform(0, 40, (n_bg, 3)))
        vs.append(rng.normal(0, 100, (n_bg, 3)))
        ms.append(np.full(n_bg, 0.1))
        gs.append(np.zeros(n_bg, np.int64))
    pos = np.concatenate(ps).astype(np.float32)
    vel = np.concatenate(vs).astype(np.float32)
    mass = np.concatenate(ms).astype(np.float32)
    pfof = np.concatenate(gs).astype(np.int64)
    perm = rng.permutation(len(pos))
    return pos[perm], vel[perm], mass[perm], pfof[perm]


def _compare(pos, vel, mass, pfof, ng, uinfo, min_size=20, boxsize=None,
             W=None):
    """Run both sides with the same W; assert exact agreement."""
    if W is None:
        W = np.asarray(JU.compute_potential(
            jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(pfof, jnp.int32),
            ng, uinfo.eps, G, boxsize=boxsize))
    want = JU.check_unbound_groups(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(pfof, jnp.int32), ng, uinfo, G, boxsize=boxsize,
        min_size=min_size, W=jnp.asarray(W))
    got = TU.check_unbound_groups(_t(pos), _t(vel), _t(mass), _t(pfof), ng,
                                  convert.unbind_info(uinfo), G,
                                  boxsize=boxsize,
                                  min_size=min_size, W=convert.potential(W))
    np.testing.assert_array_equal(got.bound.numpy(), np.asarray(want.bound))
    np.testing.assert_array_equal(got.pfof.numpy(), np.asarray(want.pfof))
    np.testing.assert_array_equal(got.gid_map.numpy(),
                                  np.asarray(want.gid_map))
    assert got.ngroups == want.ngroups
    np.testing.assert_array_equal(got.W.numpy(), np.asarray(want.W))
    np.testing.assert_allclose(got.Efrac.numpy(), np.asarray(want.Efrac),
                               rtol=1e-6)
    return got


CASES = {
    # name: (group specs, untagged particles, UnbindInfo overrides, min_size)
    "cmvelref": ([(1, 900, 0.2, 0.3), (2, 400, 0.05, 0.3),
                  (3, 150, 0.5, 0.3)], 3000, {}, 20),
    "potref": ([(1, 900, 0.2, 0.3), (2, 400, 0.05, 0.3),
                (3, 150, 0.5, 0.3)], 3000,
               {"cmvelreftype": POTREF, "Npotref": 30}, 20),
    "bgpot0": ([(1, 900, 0.2, 0.45), (2, 400, 0.1, 0.3)], 3000,
               {"bgpot": 0, "maxunbindfrac": 0.1, "eps": 1e-3}, 20),
    "usysandpart": ([(1, 600, 0.2, 0.3), (2, 400, 0.7, 0.3),
                     (3, 300, 0.05, 0.3)], 2000,
                    {"unbindtype": USYSANDPART, "minEfrac": 0.6}, 20),
    "minsize_dissolution": ([(1, 500, 0.1, 0.3), (2, 60, 0.6, 0.3),
                             (3, 45, 0.0, 2.0)], 1000, {}, 40),
    # most particles tagged: the reference runs on the full arrays
    "mostly_tagged": ([(1, 900, 0.2, 0.3), (2, 400, 0.3, 0.3)], 200,
                      {"maxunbindfrac": 0.05}, 20),
    # one group settles at once while another ejects for many chunks:
    # the working set is compacted mid-loop and the sums start afresh
    "compaction_mid_loop": ([(1, 300, 0.0, 0.3), (2, 2000, 0.4, 0.3),
                             (3, 800, 0.0, 0.3)], 9000,
                            {"maxunbindfrac": 0.02}, 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ejection_matches_reference(case, monkeypatch):
    specs, n_bg, over, min_size = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 10)
    pos, vel, mass, pfof = _multi(rng, specs, n_bg)
    uinfo = UnbindInfo(unbindflag=1, **over)
    classes = []
    real_pad_class = tseg.pad_class
    monkeypatch.setattr(tseg, "pad_class",
                        lambda x, *a: classes.append(x) or
                        real_pad_class(x, *a))
    got = _compare(pos, vel, mass, pfof, len(specs), uinfo, min_size)
    assert got.ngroups > 0
    if case == "compaction_mid_loop":
        assert len(classes) >= 2      # initial class + a compaction
    if case == "minsize_dissolution":
        assert got.gid_map[2] == 0    # the 60-member group dissolved


def test_ejection_adversarial_layout():
    """Empty group ids next to full ones, the lowest gid at slot 0 and the
    highest at the array tail, a periodic box with groups across the
    boundary."""
    rng = np.random.default_rng(77)
    pos, vel, mass, pfof = _multi(
        rng, [(2, 400, 0.2, 0.3), (5, 300, 0.3, 0.3), (6, 250, 0.1, 0.3),
              (9, 120, 0.5, 0.3)], 2500)
    first = np.nonzero(pfof == 2)[0][0]
    last = np.nonzero(pfof == 9)[0][-1]
    for a in (pos, vel, mass, pfof):
        a[[0, first]] = a[[first, 0]]
        a[[-1, last]] = a[[last, -1]]
    assert pfof[0] == 2 and pfof[-1] == 9
    boxsize = 40.0
    pos = np.mod(pos - 3.2, boxsize).astype(np.float32)   # wrap group 1
    uinfo = UnbindInfo(unbindflag=1, maxunbindfrac=0.1)
    got = _compare(pos, vel, mass, pfof, 12, uinfo, boxsize=boxsize)
    assert got.ngroups >= 3
    assert (got.gid_map[[0, 1, 3, 4, 7, 8, 10, 11, 12]] == 0).all()


def test_unbind_keeps_bound_removes_interlopers():
    """tests/test_unbind.py:92."""
    rng = np.random.default_rng(3)
    n = 1000
    pos, vel, mass = _bound_system(rng, n, np.zeros(3))
    ni = 50
    posi = pos[:ni] * 0.5
    vesc = np.sqrt(2 * G * 100.0 / 0.1)
    veli = rng.normal(0, 5 * vesc, (ni, 3))
    pos = np.concatenate([pos, posi]).astype(np.float32)
    vel = np.concatenate([vel, veli]).astype(np.float32)
    mass = np.concatenate([mass, mass[:ni]]).astype(np.float32)
    pfof = np.ones(len(pos), np.int64)
    got = _compare(pos, vel, mass, pfof, 1, UnbindInfo(unbindflag=1))
    bound = got.bound.numpy()
    assert bound[n:].sum() <= 5 and bound[:n].sum() >= 0.9 * n
    assert got.ngroups == 1


def test_unbind_dissolves_unbound_group():
    """tests/test_unbind.py:116."""
    rng = np.random.default_rng(4)
    n = 200
    pos = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 5000.0, (n, 3)).astype(np.float32)
    mass = np.full(n, 0.01, np.float32)
    got = _compare(pos, vel, mass, np.ones(n, np.int64), 1,
                   UnbindInfo(unbindflag=1))
    assert got.ngroups == 0 and int(got.pfof.max()) == 0


def test_unbind_min_bound_mass_frac():
    """tests/test_unbind.py:131 (USYSANDPART)."""
    rng = np.random.default_rng(5)
    n = 400
    pos, vel, mass = _bound_system(rng, n, np.zeros(3))
    vel[:int(0.6 * n)] = rng.normal(0, 8000.0, (int(0.6 * n), 3))
    got = _compare(pos.astype(np.float32), vel.astype(np.float32),
                   mass.astype(np.float32), np.ones(n, np.int64), 1,
                   UnbindInfo(unbindflag=1, unbindtype=USYSANDPART,
                              minEfrac=0.65))
    assert got.ngroups == 0


def test_keep_background_potential_zero_ejects_more():
    """tests/test_unbind.py:166, both sides recomputing their own
    potentials between chunks."""
    rng = np.random.default_rng(11)
    n = 2000
    pos = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    mass = np.ones(n, np.float32)
    r = np.linalg.norm(pos, axis=1)
    sig = np.sqrt(G * n / np.maximum(r.mean(), 1e-3)) * 0.55
    vel = rng.normal(0, sig, (n, 3)).astype(np.float32)
    pfof = np.ones(n, np.int64)
    nb = {}
    for bgpot in (1, 0):
        u = UnbindInfo(unbindflag=1, bgpot=bgpot, Eratio=1.0,
                       maxunbindfrac=0.05, eps=1e-3)
        nb[bgpot] = int(_compare(pos, vel, mass, pfof, 1, u).bound.sum())
    assert nb[0] < nb[1]


def test_unbind_matches_oracle():
    """tests/test_oracles.py:68: the port's ejection with its own
    potential against the reference-sequential f64 oracle."""
    rng = np.random.default_rng(51)
    n_b, n_u = 800, 120
    # tests/test_oracles.py::_plummer_halo(rng, 800, a=0.3, mtot=500,
    # vfac=0.25), then a fast far fringe
    r = 0.3 / np.sqrt(rng.uniform(0.05, 1.0, n_b) ** (-2 / 3) - 1.0 + 1e-9)
    u = rng.normal(size=(n_b, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos_b = r[:, None] * u
    vel_b = rng.normal(0, 1.0, (n_b, 3)) * 0.25 * np.sqrt(500.0 / n_b)
    ru = rng.uniform(3.0, 5.0, n_u)
    uu = rng.normal(size=(n_u, 3))
    uu /= np.linalg.norm(uu, axis=1, keepdims=True)
    pos = np.concatenate([pos_b, ru[:, None] * uu]).astype(np.float32)
    vel = np.concatenate([vel_b, rng.normal(0, 250.0, (n_u, 3))]).astype(
        np.float32)
    mass = np.full(n_b + n_u, 500.0 / n_b, np.float32)
    uinfo = UnbindInfo(unbindflag=1, Eratio=1.0, eps=0.01)
    res = TU.check_unbound_groups(_t(pos), _t(vel), _t(mass),
                                  torch.ones(n_b + n_u, dtype=torch.int64), 1,
                                  convert.unbind_info(uinfo), G, min_size=20)
    bound = res.bound.numpy()
    want = oracles.unbind_oracle(pos, vel, mass, uinfo.eps, G, Eratio=1.0,
                                 maxunbindfrac=uinfo.maxunbindfrac,
                                 min_size=20)
    assert np.mean(bound == want) >= 0.995
    assert bound[n_b:].sum() <= 0.05 * n_u
    np.testing.assert_array_equal(bound[n_b:], want[n_b:])


def test_mock_groups_ejection_matches_reference(mock_groups):
    """Cosmo-mock FOF groups in a periodic box, the reference's W."""
    pos, vel, mass, pfof, ng, boxsize = mock_groups
    got = _compare(pos, vel, mass, pfof, ng, UnbindInfo(unbindflag=1),
                   boxsize=boxsize)
    assert got.ngroups > 0
