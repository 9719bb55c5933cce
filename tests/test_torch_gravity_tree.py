"""The port's bucket tree (velociraptor_stf_tpu_torch/ops/gravity.py) and
the tree routing of its ``compute_potential`` against the JAX package.

Tolerances: bucket orders and acceptance matrices equal, potentials within
rel 1e-4 of the JAX tree (float32 sums in another order); against the
exact float64 sum, the JAX package's own tree gate
(tests/test_unbind.py::test_grid_monopole_accuracy): median rel error
< 0.005, 99th percentile < 0.03.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import halos as jhalos
from velociraptor_stf_tpu.models import unbind as JU
from velociraptor_stf_tpu.ops import gravity as JG
from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.utils.config import UnbindInfo

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import unbind as TU
from velociraptor_stf_tpu_torch.ops import gravity as TG

G = 43.0211349
CUT = 4096          # the JAX package's direct/tree cut off the TPU


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nz = want != 0
    assert np.array_equal(got[~nz], want[~nz])
    return float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])))


def _blob(rng, n):
    """tests/test_unbind.py:60-77: lognormal radii, a dense core."""
    r = np.exp(rng.normal(-1.5, 1.0, n))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (r[:, None] * d).astype(np.float32)


def _two_clumps(rng, n, sep=20.0):
    """One group of two Plummer-like clumps ``sep`` apart: bucket pairs
    across the clumps take the far-field monopole."""
    a = _blob(rng, n // 2)
    b = _blob(rng, n - n // 2) + np.float32(sep)
    return np.concatenate([a, b])


def _exact(pos, mass, eps2):
    """float64 direct sum, -G sum_j!=i m_j / sqrt(d^2 + eps2)."""
    pos = torch.from_numpy(pos.astype(np.float64))
    mass = torch.from_numpy(np.asarray(mass, np.float64))
    out = torch.zeros(len(pos), dtype=torch.float64)
    for i in range(0, len(pos), 2000):
        d = torch.cdist(pos[i:i + 2000], pos,
                        compute_mode="donot_use_mm_for_euclid_dist")
        w = mass[None, :] / torch.sqrt(d * d + eps2)
        w[torch.arange(len(w)), torch.arange(i, i + len(w))] = 0.0
        out[i:i + 2000] = -G * w.sum(1)
    return out.numpy()


def _structures(posb, massb, q):
    want = [JG._bucket_structure(jnp.asarray(p), jnp.asarray(m), q, 0.4)
            for p, m in zip(posb, massb)]
    got = TG.bucket_structure(_t(posb), _t(massb), q, 0.4)
    return want, got


@pytest.mark.parametrize("q,n", [(1024, 20000), (64, 8000)])
def test_tree_matches_reference_blob(q, n):
    """The 20,000-particle blob; q = 64 on 8,000 gives 125 buckets."""
    pos = _blob(np.random.default_rng(2), n)[None]
    mass = np.ones(pos.shape[:2], np.float32)
    (want_s,), got_s = _structures(pos, mass, q)
    w_pad, w_dir = want_s[0], want_s[5]
    g_pad, g_dir = got_s[0], got_s[5]
    np.testing.assert_array_equal(g_pad[0].numpy(), np.asarray(w_pad))
    np.testing.assert_array_equal(g_dir[0].numpy(), np.asarray(w_dir))
    want = np.asarray(JG.bucket_tree_potential_batch(pos, mass, 1e-6, G,
                                                     q=q))
    got = TG.bucket_tree_potential_batch(_t(pos), _t(mass), 1e-6, G,
                                         q=q).numpy()
    assert _rel(got, want) < 1e-4


def test_tree_two_group_batch_with_padding():
    """Two groups in one power-of-two class, padded with zero-mass copies
    of each group's last member as compute_potential pads them: the
    padding goes through the Morton sort and shapes the buckets; 20,000
    slots are padded again to a multiple of q."""
    rng = np.random.default_rng(3)
    sizes = (13000, 16000)
    K = 20000
    posb = np.zeros((2, K, 3), np.float32)
    massb = np.zeros((2, K), np.float32)
    valid = np.zeros((2, K), bool)
    for i, (n, p) in enumerate(zip(sizes, (_two_clumps(rng, sizes[0]),
                                           _blob(rng, sizes[1])))):
        posb[i, :n], posb[i, n:] = p, p[-1]
        massb[i, :n] = rng.uniform(0.5, 2.0, n)
        valid[i, :n] = True
    want_s, got_s = _structures(posb, massb, 1024)
    for i in range(2):
        np.testing.assert_array_equal(got_s[0][i].numpy(),
                                      np.asarray(want_s[i][0]))
        np.testing.assert_array_equal(got_s[5][i].numpy(),
                                      np.asarray(want_s[i][5]))
    assert not bool(got_s[5][0].all())       # the clumps are far apart
    want = np.asarray(JG.bucket_tree_potential_batch(posb, massb, 1e-6, G))
    got = TG.bucket_tree_potential_batch(_t(posb), _t(massb), 1e-6, G,
                                         valid=_t(valid)).numpy()
    assert _rel(got[valid], want[valid]) < 1e-4
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("kind", ["blob", "two_clumps"])
def test_tree_against_exact_sum(kind):
    rng = np.random.default_rng(4)
    n = 12000
    pos = _blob(rng, n) if kind == "blob" else _two_clumps(rng, n)
    mass = np.ones(n, np.float32)
    q = 64 if kind == "blob" else 1024
    got = TG.bucket_tree_potential_batch(_t(pos[None]), _t(mass[None]),
                                         1e-6, G, q=q)[0].numpy()
    exact = _exact(pos, mass.astype(np.float64), 1e-6)
    err = np.abs(got - exact) / np.abs(exact)
    assert np.median(err) < 0.005
    assert np.percentile(err, 99) < 0.03
    if kind == "two_clumps":            # the monopoles were taken
        direct = TG.bucket_structure(_t(pos[None]), _t(mass[None]), q,
                                     0.4)[5]
        assert not bool(direct.all())


@pytest.fixture(scope="module")
def big_group_mock():
    """3DFOF groups of a periodic mock whose largest group (6629 members)
    is above the cut."""
    boxsize, n = 32.0, 1 << 15
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=8, seed=7)
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF3D
    opt.MinSize = 20
    opt.HaloMinSize = 20
    C.config_check(opt)
    r = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(mass), boxsize=boxsize)
    pfof = np.asarray(r.pfof)
    assert np.bincount(pfof)[1] > CUT
    return pos, vel, mass, pfof, r.ngroups, boxsize


@pytest.mark.parametrize("eps", [0.0, 0.01])
def test_compute_potential_tree_matches_reference(big_group_mock, eps):
    """With eps = 0 the JAX tree gives NaN to the big group's last member
    (a zero-mass padding copy on top of it: 0 * inf); the port's padding
    contributes nothing and every value is finite."""
    pos, _, mass, pfof, ng, boxsize = big_group_mock
    want = np.asarray(JU.compute_potential(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(pfof), ng, eps, G,
        boxsize=boxsize))
    got = TU.compute_potential(_t(pos), _t(mass), convert.group_ids(pfof),
                               ng, eps, G, boxsize=boxsize,
                               direct_cut=CUT).numpy()
    assert np.isfinite(got).all()
    ok = np.isfinite(want)
    assert (~ok).sum() == (1 if eps == 0.0 else 0)
    assert _rel(got[ok], want[ok]) < 1e-4


def test_compute_potential_default_cut_is_exact(big_group_mock):
    """Below MAX_DIRECT every group is summed directly."""
    pos, _, mass, pfof, ng, boxsize = big_group_mock
    big = pfof == 1
    W = TU.compute_potential(_t(pos), _t(mass), convert.group_ids(pfof), ng,
                             0.01, G, boxsize=boxsize).numpy()
    upos = TU.seg.unwrap_positions(_t(pos), convert.group_ids(pfof),
                                   boxsize, ng).numpy()
    exact = _exact(upos[big], mass[big].astype(np.float64), 1e-4) * \
        mass[big]
    assert _rel(W[big], exact) < 1e-4


def test_bound_masks_match_reference(big_group_mock):
    """The JAX unbind (its tree above 4096 members) against the port's,
    fed the port's potential with the same cut."""
    pos, vel, mass, pfof, ng, boxsize = big_group_mock
    uinfo = UnbindInfo(unbindflag=1, eps=0.01)
    want = JU.check_unbound_groups(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(pfof), ng, uinfo, G, boxsize=boxsize, min_size=20)
    W = TU.compute_potential(_t(pos), _t(mass), convert.group_ids(pfof), ng,
                             uinfo.eps, G, boxsize=boxsize, direct_cut=CUT)
    got = TU.check_unbound_groups(_t(pos), _t(vel), _t(mass),
                                  convert.group_ids(pfof), ng, uinfo, G,
                                  boxsize=boxsize, min_size=20, W=W)
    np.testing.assert_array_equal(got.bound.numpy(), np.asarray(want.bound))
    np.testing.assert_array_equal(got.pfof.numpy(), np.asarray(want.pfof))
    assert got.ngroups == want.ngroups > 0
