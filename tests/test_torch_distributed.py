"""The port's sharded stages (velociraptor_stf_tpu_torch/parallel/) on
meshes of CPU shards, on the mocks of tests/test_distributed.py (the JAX
package's mesh tests): the slab FOF (3D and 6D, groups spanning every
slab, heavy boundary columns), the whole-groups unbind (with and without
the potential recomputed), the reduced bulk properties, the psum'd SO
histograms, the sharded velocity density and the structure deal of the
recursion.  Each is held to the port's single-device function and to the
JAX package's single-device one.

Gates are the JAX tests': partitions exact, bound masks exact, bulk
properties against float64 numpy at the JAX test's tolerances, SO at rtol
5e-5; for the density the JAX test's statistics (median |log ratio| <
0.2, top-5% overlap > 0.9, clump > 10x background).  The port also holds
the potentials of the mesh unbind equal to one device's bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import halos as jhalos
from velociraptor_stf_tpu.models import localfield as jlocalfield
from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.models import unbind as jub
from velociraptor_stf_tpu.ops import fof as jfof
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import host_with_subhalo
from velociraptor_stf_tpu_torch.models import halos as thalos
from velociraptor_stf_tpu_torch.models import localfield
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.models import unbind as tub
from velociraptor_stf_tpu_torch.ops import fof as tfof
from velociraptor_stf_tpu_torch.ops import so
from velociraptor_stf_tpu_torch.parallel.distributed_fof import (
    distributed_fof3d, distributed_fof6d)
from velociraptor_stf_tpu_torch.parallel.distributed_localfield import \
    distributed_velocity_density
from velociraptor_stf_tpu_torch.parallel.distributed_props import \
    distributed_bulk_properties
from velociraptor_stf_tpu_torch.parallel.distributed_so import \
    distributed_so_masses
from velociraptor_stf_tpu_torch.parallel.distributed_substructure import \
    distributed_structure_search
from velociraptor_stf_tpu_torch.parallel.distributed_unbind import \
    distributed_unbind
from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh
from velociraptor_stf_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401

G = 43.0211349


def _t(a):
    return torch.from_numpy(np.array(a))


def _partition_equal(a, b):
    """Two labelings describe the same partition (ids may differ)."""
    a, b = np.asarray(a), np.asarray(b)
    if not ((a == 0) == (b == 0)).all():
        return False
    sel = a > 0
    pa, pb = a[sel].astype(np.int64), b[sel].astype(np.int64)
    if pa.size == 0:
        return True
    pairs = np.unique(pa * (pb.max() + 2) + pb).size
    return pairs == np.unique(pa).size == np.unique(pb).size


def _fof_both(pos, b, boxsize, min_size=20):
    """(port, JAX) single-device 3DFOF ids."""
    port, ng = tfof.fof3d(_t(pos), b, boxsize=boxsize, min_size=min_size)
    want, ngj = jfof.fof3d(pos, b, boxsize=boxsize, min_size=min_size)
    assert ng == int(ngj)
    return port.numpy(), ng, np.asarray(want)


@pytest.fixture(scope="module")
def cosmo15():
    n, boxsize = 1 << 15, 20.0
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=12, seed=21)
    b = 0.2 * boxsize / n ** (1 / 3)
    return pos, b, boxsize, _fof_both(pos, b, boxsize)


@pytest.mark.parametrize("ndev", [2, 8])
def test_distributed_fof_matches_single_device(cosmo15, ndev):
    pos, b, boxsize, (port, ng, want) = cosmo15
    got, ngd = distributed_fof3d(_t(pos), b, boxsize,
                                 make_mesh(ndev, "cpu"), min_size=20)
    assert ngd == ng > 0
    np.testing.assert_array_equal(got.numpy(), port)
    assert _partition_equal(got.numpy(), want)


def test_distributed_fof_group_spanning_many_slabs():
    """A filament along x through every slab boundary, wrapped
    periodically: one group, found over several cross-slab rounds."""
    rng = np.random.default_rng(5)
    boxsize, n_fil = 16.0, 4000
    xs = np.linspace(0, boxsize, n_fil, endpoint=False)
    fil = np.stack([xs, np.full(n_fil, 8.0), np.full(n_fil, 8.0)], axis=1)
    fil += rng.normal(0, 0.005, fil.shape)
    bg = rng.random((20000, 3)) * boxsize
    pos = np.concatenate([fil, bg]).astype(np.float32) % boxsize
    telemetry.reset()
    got, ng = distributed_fof3d(_t(pos), 0.05, boxsize,
                                make_mesh(8, "cpu"), min_size=20)
    lab = got.numpy()[:n_fil]
    assert (lab > 0).all() and len(np.unique(lab)) == 1
    assert telemetry.snapshot()["fof3d_outer_rounds"] >= 4
    port, _, want = _fof_both(pos, 0.05, boxsize)
    np.testing.assert_array_equal(got.numpy(), port)
    assert _partition_equal(got.numpy(), want)


def test_distributed_fof6d_matches_single_device():
    """3DFOF, the shards' velocity scales and 6DFOF with the velocities
    riding the ghost exchange: the port's single-device FOF6DADAPTIVE
    search exactly, and the JAX package's."""
    n, boxsize = 1 << 15, 20.0
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=12, seed=23)
    b = 0.2 * boxsize / n ** (1 / 3)
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF6DADAPTIVE
    opt.MinSize = opt.HaloMinSize = 20
    C.config_check(opt)
    one = thalos.search_full_set(convert.options(opt), _t(pos), _t(vel),
                                 _t(mass), boxsize=boxsize)
    got, ng, got3, ng3 = distributed_fof6d(
        _t(pos), _t(vel), _t(mass), b, opt.ellhalo6dxfac, opt.ellhalo6dvfac,
        boxsize, make_mesh(8, "cpu"), min_size=20, adaptive=True)
    assert (ng, ng3) == (one.ngroups, one.ngroups3d)
    np.testing.assert_array_equal(got.numpy(), one.pfof.numpy())
    np.testing.assert_array_equal(got3.numpy(), one.pfof3d.numpy())
    want = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(mass), boxsize=boxsize)
    assert ng == want.ngroups
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.pfof))


def test_distributed_fof6d_group_spanning_many_slabs():
    """A cold stream through every slab under the 6D criterion, with a
    velocity break halfway: one 3D group, two 6D groups."""
    rng = np.random.default_rng(9)
    boxsize, n_fil = 16.0, 6000
    xs = np.linspace(0, boxsize, n_fil, endpoint=False)
    fil = np.stack([xs, np.full(n_fil, 8.0), np.full(n_fil, 8.0)], axis=1)
    fil += rng.normal(0, 0.004, fil.shape)
    vfil = np.tile(np.array([50.0, 0.0, 0.0]), (n_fil, 1))
    vfil[xs >= boxsize / 2] = np.array([-50.0, 0.0, 0.0])
    vfil += rng.normal(0, 0.5, vfil.shape)
    bg = rng.random((20000, 3)) * boxsize
    vbg = rng.normal(0, 300.0, (20000, 3))
    pos = np.concatenate([fil, bg]).astype(np.float32) % boxsize
    vel = np.concatenate([vfil, vbg]).astype(np.float32)
    mass = np.ones(len(pos), np.float32)
    got6, ng6, got3, ng3 = distributed_fof6d(
        _t(pos), _t(vel), _t(mass), 0.05, 1.0, 1.0, boxsize,
        make_mesh(8, "cpu"), min_size=20, adaptive=True)
    lab3, lab6 = got3.numpy()[:n_fil], got6.numpy()[:n_fil]
    assert len(np.unique(lab3)) == 1 and (lab3 > 0).all()
    assert len(np.unique(lab6[lab6 > 0])) == 2
    left, right = lab6[xs < boxsize / 2], lab6[xs >= boxsize / 2]
    assert len(np.unique(left[left > 0])) == 1
    assert len(np.unique(right[right > 0])) == 1
    # the port's single-device 6D pass on the same 3D groups and scales
    sig2 = thalos.group_dispersion2(_t(vel), _t(mass), got3, ng3 + 1)
    vs = torch.where(got3 > 0, torch.clamp_min(sig2[got3], 1e-30), 1.0)
    from velociraptor_stf_tpu_torch.ops.fof_sweep import SweepFof
    one = SweepFof(_t(pos), _t(vel), boxsize, 0.05).subset(got3 > 0)
    want6, ngw = one.fof6d(0.05, got3, vs, 20)
    assert ngw == ng6
    np.testing.assert_array_equal(got6.numpy(), want6.numpy())


def test_distributed_fof_boundary_buffer_pressure():
    """Thin dense sheets on every slab boundary: every sheet particle
    travels as a ghost, and the sheets form groups across the cut."""
    rng = np.random.default_rng(77)
    boxsize, ndev, b = 16.0, 8, 0.25
    # the plan's slab edges: W = 64 // 8 columns of width 16 / 64
    pos_bg = rng.uniform(0, boxsize, (1 << 13, 3)).astype(np.float32)
    sheets = []
    for k in range(ndev):
        xb = k * boxsize / ndev
        s = np.empty((1 << 12, 3), np.float32)
        s[:, 0] = xb + rng.uniform(-0.4 * b, 0.4 * b, 1 << 12)
        s[:, 1:] = rng.uniform(0, boxsize, (1 << 12, 2))
        sheets.append(s)
    pos = (np.concatenate([pos_bg] + sheets) % boxsize).astype(np.float32)
    telemetry.reset()
    got, ng = distributed_fof3d(_t(pos), b, boxsize, make_mesh(ndev, "cpu"),
                                min_size=20)
    assert ng > 0
    ghosts = telemetry.snapshot()["coll_bytes::fof3d::ppermute"]
    assert ghosts > (1 << 12) * 12      # a sheet's positions per link
    port, ngs, want = _fof_both(pos, b, boxsize)
    assert ng == ngs
    np.testing.assert_array_equal(got.numpy(), port)
    assert _partition_equal(got.numpy(), want)


def _unbind_case(n, nhalos, seed, bgpot):
    boxsize = 20.0
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=nhalos,
                                     seed=seed)
    b = 0.2 * boxsize / n ** (1 / 3)
    pfof, ng = tfof.fof3d(_t(pos), b, boxsize=boxsize, min_size=20)
    pfof = pfof.numpy()
    uinfo = C.UnbindInfo()
    uinfo.unbindflag = 1
    uinfo.Eratio = 1.0
    uinfo.bgpot = bgpot
    return pos, vel, mass, pfof, ng, uinfo, boxsize


@pytest.mark.parametrize("case", ["keep", "recompute"])
def test_distributed_unbind_matches_single_device(case):
    """Whole groups per shard, the ejections in lockstep: the bound masks,
    ids and initial potentials of one device, bit for bit, and the bound
    masks of the JAX package (whose CPU compile this test pays once, for
    Keep_background_potential=1)."""
    n, nh, seed, bgpot, ndev = {"keep": (1 << 14, 10, 31, 1, 8),
                                "recompute": (1 << 13, 6, 32, 0, 4)}[case]
    pos, vel, mass, pfof, ng, uinfo, boxsize = _unbind_case(n, nh, seed,
                                                            bgpot)
    assert ng >= 2
    tuinfo = convert.options(C.Options()).uinfo
    for k, v in vars(uinfo).items():
        setattr(tuinfo, k, v)
    one = tub.check_unbound_groups(_t(pos), _t(vel), _t(mass), _t(pfof), ng,
                                   tuinfo, G, boxsize=boxsize, min_size=20)
    got = distributed_unbind(_t(pos), _t(vel), _t(mass), _t(pfof), ng,
                             tuinfo, G, make_mesh(ndev, "cpu"),
                             boxsize=boxsize, min_size=20)
    assert got.ngroups == one.ngroups > 0
    assert torch.equal(got.bound, one.bound)
    assert torch.equal(got.pfof, one.pfof)
    assert torch.equal(got.W, one.W)
    assert torch.equal(got.gid_map, one.gid_map)
    if case == "recompute":
        return
    want = jub.check_unbound_groups(pos, vel, mass, pfof, ng, uinfo, G,
                                    boxsize=boxsize, min_size=20)
    assert got.ngroups == want.ngroups
    np.testing.assert_array_equal(got.bound.numpy(),
                                  np.asarray(want.bound))


def test_distributed_bulk_properties_match_numpy():
    """Shards' float64 partial sums against a float64 host computation
    (tests/test_distributed.py:213 at its tolerances)."""
    rng = np.random.default_rng(88)
    n, ng, boxsize = 20000, 6, 10.0
    pfof = rng.integers(0, ng + 1, n).astype(np.int64)
    pos = rng.uniform(0, boxsize, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 30, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 2, n).astype(np.float32)
    out = distributed_bulk_properties(_t(pos), _t(vel), _t(mass), _t(pfof),
                                      ng, make_mesh(8, "cpu"),
                                      boxsize=boxsize)
    for g in range(1, ng + 1):
        s = pfof == g
        m = mass[s].astype(np.float64)
        ref = pos[s][0].astype(np.float64)
        d = pos[s].astype(np.float64) - ref
        p = ref + d - boxsize * np.round(d / boxsize)
        mt = m.sum()
        cm = (p * m[:, None]).sum(0) / mt
        cmv = (vel[s].astype(np.float64) * m[:, None]).sum(0) / mt
        assert out["num"][g] == s.sum()
        assert abs(out["gmass"][g] - mt) / mt < 1e-5
        np.testing.assert_allclose(out["gcm"][g], cm, rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(out["gcmvel"][g], cmv, rtol=2e-4,
                                   atol=2e-3)
        dx = p - cm
        dv = vel[s].astype(np.float64) - cmv
        disp = np.einsum("ni,nj,n->ij", dv, dv, m) / mt
        np.testing.assert_allclose(out["gveldisp"][g], disp, rtol=2e-3,
                                   atol=1e-2)
        J = (m[:, None] * np.cross(dx, dv)).sum(0)
        np.testing.assert_allclose(out["gJ"][g], J, rtol=5e-3,
                                   atol=1e-2 * np.abs(J).max())
        rmax = np.sqrt((dx ** 2).sum(1).max())
        assert abs(out["gsize"][g] - rmax) / rmax < 1e-4
        np.testing.assert_allclose(out["gsigma_v"][g],
                                   np.sqrt(np.trace(disp) / 3), rtol=2e-3)


def test_distributed_so_matches_single_device():
    """Shard histograms added by psum: the single-device SO of the port
    and the JAX package's on every halo and threshold."""
    from velociraptor_stf_tpu.ops import so as jso

    rng = np.random.default_rng(31)
    boxsize = 12.0
    centers, chunks = [], []
    for k in range(5):
        nk = 2000 * (k + 1)
        c = rng.uniform(2, boxsize - 2, 3)
        r = (0.15 + 0.1 * k) * rng.random(nk) ** (1 / 3)
        d = rng.normal(size=(nk, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        chunks.append(c + d * r[:, None])
        centers.append(c)
    chunks.append(rng.random((30011, 3)) * boxsize)
    pos = np.concatenate(chunks).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, len(pos)).astype(np.float32)
    centers = np.asarray(centers, np.float32)
    rsearch = np.array([2.0, 1.5, 2.5, 1.0, 3.0])
    rho0 = len(pos) / boxsize ** 3
    lnthr = [math.log(200 * rho0), math.log(500 * rho0)]
    minnum = np.full(5, 8, np.int32)
    fm = np.full(5, 0.5, np.float64)
    M1, R1 = so.so_masses_all_particles(_t(pos), _t(mass), centers, rsearch,
                                        lnthr, boxsize=boxsize,
                                        minnum=minnum, first_mass=fm)
    M8, R8 = distributed_so_masses(_t(pos), _t(mass), centers, rsearch,
                                   lnthr, make_mesh(8, "cpu"),
                                   boxsize=boxsize, minnum=minnum,
                                   first_mass=fm)
    assert (M1 > 0).any()
    np.testing.assert_allclose(M8, M1, rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(R8, R1, rtol=5e-5, atol=1e-6)
    MJ, RJ = jso.so_masses_all_particles(pos, mass, centers, rsearch, lnthr,
                                         boxsize=boxsize, minnum=minnum,
                                         first_mass=fm)
    np.testing.assert_allclose(M8, np.asarray(MJ), rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(R8, np.asarray(RJ), rtol=5e-5, atol=1e-6)


def test_distributed_velocity_density_matches_single_device():
    """x-slab leaves with the neighbours' leaves as candidates, against
    the port's and the JAX package's single-device densities at the JAX
    test's statistics (tests/test_distributed.py:300-346)."""
    rng = np.random.default_rng(77)
    boxsize = 10.0
    nclump, nbg = 4000, 28000
    cpos = np.array([boxsize / 8, 5.0, 5.0]) + \
        rng.normal(0, 0.15, (nclump, 3))
    cvel = rng.normal(0, 20.0, (nclump, 3))
    bpos = rng.random((nbg, 3)) * boxsize
    bvel = rng.normal(0, 300.0, (nbg, 3))
    pos = (np.concatenate([cpos, bpos]) % boxsize).astype(np.float32)
    vel = np.concatenate([cvel, bvel]).astype(np.float32)
    d8 = distributed_velocity_density(_t(pos), _t(vel), make_mesh(8, "cpu"),
                                      nvel=32, nsearch=256,
                                      boxsize=boxsize).numpy()
    d1 = localfield.velocity_density(_t(pos), _t(vel), nvel=32,
                                     nsearch=256).numpy()
    dj = np.asarray(jlocalfield.velocity_density(
        jnp.asarray(pos), jnp.asarray(vel), nvel=32, nsearch=256))
    assert d8.shape == (len(pos),) and (d8 > 0).all()
    k = len(pos) // 20
    for ref in (d1, dj):
        logr = np.log(d8) - np.log(ref)
        assert np.median(np.abs(logr)) < 0.2
        top1 = set(np.argsort(-ref)[:k])
        top8 = set(np.argsort(-d8)[:k])
        assert len(top1 & top8) / k > 0.9
    assert np.median(d8[:nclump]) > 10 * np.median(d8[nclump:])


def test_distributed_structure_search_matches_single_device():
    """Three structures of one pad size dealt whole to 8 shards (five
    shards idle): each shard's subset and core searches give the ids of
    the searches on one device and of the JAX package's batched search."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.25
    opt.iiterflag = 1
    opt.ellthreshold, opt.Vratio, opt.thetaopen, opt.ellfac = \
        2.5, 2.0, 0.10, 1.0
    opt.MinSize = 20
    opt.G = G
    topt = convert.options(opt)
    pad_spacing = 3.0 * opt.ellxscale * opt.ellphys
    jentries, one, dealt = [], [], []
    for k in range(3):
        pos, vel, mass, _ = host_with_subhalo(seed=20 + k, nhost=2500,
                                              nsub=350)
        npad = JS._next_pow2(len(pos))
        ppos, pvel, pmass, valid = JS._pad_structure(pos, vel, mass, npad,
                                                     pad_spacing)
        ell, _, _ = TS.structure_outliers(topt, _t(ppos), _t(pvel),
                                          _t(pmass), _t(valid))
        jentries.append({"ppos": ppos, "pvel": pvel, "pmass": pmass,
                         "valid": valid, "ell": ell.numpy(), "npad": npad})
        nsub = len(pos)
        ppos_np = np.asarray(ppos)
        e = {"ppos": _t(ppos_np), "pvel": _t(np.asarray(pvel)),
             "pmass": _t(np.asarray(pmass)), "valid": _t(np.asarray(valid)),
             "ell": ell, "nsub": nsub,
             "npad": npad, "bounds": (ppos_np.min(0).astype(np.float64),
                                      ppos_np.max(0).astype(np.float64))}
        one.append(dict(e))
        dealt.append(dict(e))
    TS.search_subset_batch(topt, one)
    TS.search_level_cores(topt, one, 1, False)
    distributed_structure_search(topt, dealt, 1, False, make_mesh(8, "cpu"))
    JS._search_subset_batch(opt, jentries)
    assert sum(e["ng_sub"] for e in one) > 0
    for a, b, j in zip(one, dealt, jentries):
        assert a["ng_sub"] == b["ng_sub"]
        assert torch.equal(a["sub"], b["sub"])
        assert j["ng_sub"] == b["ng_sub"]
        np.testing.assert_array_equal(b["sub"].numpy(),
                                      np.asarray(j["sub_np"])[:b["nsub"]])
