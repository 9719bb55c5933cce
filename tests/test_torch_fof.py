"""The port's FOF (velociraptor_stf_tpu_torch: ops/fof_sweep.py,
models/halos.py) against the JAX package on the same numpy inputs.

On the CPU the port runs its kernels' plain versions and the JAX package
takes its XLA edge pipeline (its Pallas sweep runs only on a TPU or in
interpret mode, see test_torch_interpret.py).  Group ids must be
array-equal; velocity scales agree within rel 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.spatial import cKDTree

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import halos as jhalos
from velociraptor_stf_tpu.ops import pallas_fof as PF
from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.validation import oracles

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import halos as thalos
from velociraptor_stf_tpu_torch.ops import cells
from velociraptor_stf_tpu_torch.ops import fof_sweep as TF
from torch_threads import one_torch_thread  # noqa: F401


def _opts(boxsize, n, fofbgtype=C.FOF6D, keepfof=0):
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = fofbgtype
    opt.MinSize = 20
    opt.HaloMinSize = 32
    opt.iKeepFOF = keepfof
    C.config_check(opt)
    return opt


def _t(a):
    return torch.from_numpy(np.array(a))


def _mock():
    boxsize = 25.0
    pos, vel, mass = make_cosmo_mock(1 << 14, boxsize=boxsize, nhalos=6,
                                     seed=7)
    return pos, vel, mass, boxsize


def _clustered():
    """tests/test_pallas_interpret.py's clustered-dense box: one tight
    clump filling single cells, one across the periodic corner, sparse
    background."""
    rng = np.random.default_rng(3)
    boxsize = 20.0
    clump1 = rng.normal([4.0, 4.0, 4.0], 0.05, (9000, 3))
    clump2 = rng.normal([0.1, 19.9, 0.1], 0.08, (4000, 3)) % boxsize
    bg = rng.uniform(0, boxsize, (3500, 3))
    pos = np.vstack([clump1, clump2, bg]).astype(np.float32)
    n = pos.shape[0]
    vel = rng.normal(0, 30, (n, 3)).astype(np.float32)
    return pos, vel, np.ones(n, np.float32), boxsize


def _jax_search(opt, pos, vel, mass, boxsize):
    r = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                               jnp.asarray(mass), boxsize=boxsize)
    return r


def _port_search(opt, pos, vel, mass, boxsize):
    return thalos.search_full_set(convert.options(opt), _t(pos), _t(vel),
                                  _t(mass), boxsize=boxsize)


def test_context_matches_reference():
    """Ghosts, cell sort and slot maps equal the JAX ``build_fof_ctx``."""
    pos, vel, _, boxsize = _mock()
    reach = 0.2 * boxsize / len(pos) ** (1 / 3)
    jctx, jgrid = PF.build_fof_ctx(jnp.asarray(pos), jnp.asarray(vel),
                                   boxsize, reach, return_grid=True)
    tctx, tgrid = TF.build_fof_ctx(_t(pos), boxsize, reach)
    assert tgrid == (jgrid.ncells, jgrid.origin, jgrid.width)
    jsrc = np.asarray(jctx.src)
    ns = tctx.ns
    assert (jsrc[:ns] >= 0).all() and (jsrc[ns:] < 0).all()
    np.testing.assert_array_equal(tctx.src.numpy(), jsrc[:ns])
    np.testing.assert_array_equal(tctx.is_real.numpy(),
                                  np.asarray(jctx.is_real)[:ns])
    np.testing.assert_array_equal(tctx.real_slot.numpy(),
                                  np.asarray(jctx.real_slot))
    np.testing.assert_array_equal(tctx.cx.numpy(),
                                  np.asarray(jctx.ccx)[:ns])
    np.testing.assert_array_equal(tctx.cr.numpy(),
                                  np.asarray(jctx.ccr)[:ns])
    # positions, ghosts shifted, as the reference's bit-cast rows
    jpos = np.asarray(jctx.cols_p)[:3, :ns].view(np.float32)
    np.testing.assert_array_equal(tctx.pos.numpy(), jpos)
    assert tctx.gslots.numel() == int((~tctx.is_real).sum()) > 0
    np.testing.assert_array_equal(
        tctx.src[tctx.grs].numpy(), tctx.src[tctx.gslots].numpy())


def test_windows_are_disjoint_supersets():
    """Cell windows: disjoint per cell, and every neighbour of every row
    lies in its cell's windows."""
    pos, _, _, boxsize = _clustered()
    reach = 0.2 * boxsize / len(pos) ** (1 / 3)
    ctx, _ = TF.build_fof_ctx(_t(pos), boxsize, reach)
    cell, win = TF.cell_windows(ctx.cx, ctx.cr, ctx.ncells)
    cell, w = cell.long().numpy(), win.long().numpy()
    # each cell's windows sorted by start: disjoint when each ends before
    # the next starts
    start = np.where(w[:, :, 1] > 0, w[:, :, 0], ctx.ns)
    by = np.argsort(start, axis=1, kind="stable")
    start = np.take_along_axis(start, by, 1)
    end = start + np.take_along_axis(w[:, :, 1], by, 1)
    assert (end[:, :-1] <= start[:, 1:]).all()
    # the slot j in cell c's windows: the last window of c starting at or
    # before j holds it (cells ascending, starts ascending in each cell)
    ncell = w.shape[0]
    key = (np.arange(ncell)[:, None] * (ctx.ns + 1) + start).ravel()
    p = ctx.pos.numpy().T
    pairs = cKDTree(p).query_pairs(reach, output_type="ndarray")
    assert len(pairs) > 0
    for i, j in ((pairs[:, 0], pairs[:, 1]), (pairs[:, 1], pairs[:, 0])):
        k = np.searchsorted(key, cell[i] * (ctx.ns + 1) + j, "right") - 1
        assert (k // 9 == cell[i]).all()
        assert (j < end.ravel()[k]).all()


def test_each_context_builds_only_its_windows_once(monkeypatch):
    """The field search builds the column index once, for detect on the
    full context, and cell windows once for each subset its fixed points
    sweep (the linked subset, then the 6D subset), however many sweeps
    run."""
    calls, sweeps = [], []
    for name in ("column_index", "cell_windows"):
        fn = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda cx, *a, _fn=fn, _name=name: (
            calls.append((_name, int(cx.shape[0]))) or _fn(cx, *a)))
    for name in ("sweep3d", "sweep6d"):
        fn = getattr(TF.K, name)
        monkeypatch.setattr(TF.K, name, lambda *a, _fn=fn, _name=name: (
            sweeps.append(_name) or _fn(*a)))
    pos, vel, mass, boxsize = _mock()
    got = _port_search(_opts(boxsize, len(pos)), pos, vel, mass, boxsize)
    assert got.ngroups > 0
    assert [c[0] for c in calls] == ["column_index", "cell_windows",
                                     "cell_windows"]
    assert calls[0][1] > calls[1][1] > calls[2][1]
    assert sweeps.count("sweep3d") >= 2 and sweeps.count("sweep6d") >= 2


def test_linked_mask_matches_kdtree():
    """Sparse geometry of tests/test_pallas_interpret.py: isolated
    particles must not be kept (overlapping windows would count self
    twice and keep every particle)."""
    rng = np.random.default_rng(5)
    boxsize = 40.0
    ll = 0.25
    npair = 300
    base = rng.uniform(2, boxsize - 2, (npair, 3))
    partner = base + rng.normal(0, ll / 4, (npair, 3))
    gx = np.arange(1, 39, 2.0)
    singles = np.stack(np.meshgrid(gx, gx, [20.0]), -1).reshape(-1, 3)
    singles = singles + rng.uniform(0.3, 0.6, singles.shape)
    pos = np.vstack([base, partner, singles]).astype(np.float32)
    n = len(pos)
    fof = TF.SweepFof(_t(pos), _t(np.zeros((n, 3), np.float32)), boxsize,
                      ll)
    keep, nkeep = fof.linked_mask(ll)
    pairs = cKDTree(pos, boxsize=boxsize).query_pairs(
        ll, output_type="ndarray")
    truth = np.zeros(n, bool)
    truth[pairs.ravel()] = True
    np.testing.assert_array_equal(keep.numpy(), truth)
    assert nkeep == truth.sum()


def test_limit_columns_halves_only_what_exceeds():
    """nx and ny halve together until nx * ny fits, nz only above its own
    cap; the extent stays, and a grid within both limits comes back as it
    is."""
    grid = cells.build_grid(np.zeros(3), np.array([100.0, 50.0, 1e4]), 0.1)
    assert grid.ncells == (1000, 500, 100000)
    assert cells.limit_columns(grid, 500000) is grid
    got = cells.limit_columns(grid, 499999, max_depth=30000)
    assert got.ncells == (500, 250, 25000) and got.origin == grid.origin
    np.testing.assert_allclose(np.array(got.width) * got.ncells,
                               np.array(grid.width) * grid.ncells, rtol=1e-12)
    assert cells.limit_columns(grid, 0).ncells == (1, 1, 100000)
    assert cells.limit_columns(grid, 3).ncells == (3, 1, 100000)
    thin = cells.limit_columns(grid._replace(ncells=(1000, 1, 7)), 100)
    assert thin.ncells == (62, 1, 7)


def test_uneven_open_domain_gets_wider_cells_and_equal_groups(monkeypatch):
    """Two clumps far apart in an open domain: the grid at the linking
    length would have far more z-columns than slots, so the context
    halves nx and ny until they number at most four a slot.  The groups
    equal those on the uncoarsened grid, and the brute-force links."""
    rng = np.random.default_rng(12)
    ll = 0.05
    pos = np.vstack([rng.normal(0.0, 0.4, (1500, 3)),
                     rng.normal(400.0, 0.4, (1500, 3))]).astype(np.float32)
    vel = np.zeros_like(pos)
    n = len(pos)

    def run():
        fof = TF.SweepFof(_t(pos), _t(vel), None, ll)
        keep, nkeep = fof.linked_mask(ll)
        pfof, ng = fof.subset(keep).fof3d(ll, 5)
        return fof.ctx, keep, pfof, ng

    ctx, keep, pfof, ng = run()
    nx, ny, nz = ctx.ncells
    assert nx * ny <= TF.MAX_COLUMNS_PER_SLOT * n < 1000 * nz
    assert ctx.detect_index[1].shape == (nx * ny + 1,)
    monkeypatch.setattr(TF, "MAX_COLUMNS_PER_SLOT", 10**9)
    ctx0, keep0, pfof0, ng0 = run()
    assert ctx0.ncells[0] * ctx0.ncells[1] > 1000 * n
    assert ctx0.ncells[2] == nz
    assert ng == ng0 > 10
    assert torch.equal(keep, keep0) and torch.equal(pfof, pfof0)
    pairs = cKDTree(pos.astype(np.float64)).query_pairs(
        ll, output_type="ndarray")
    truth = np.zeros(n, bool)
    truth[pairs.ravel()] = True
    np.testing.assert_array_equal(keep.numpy(), truth)


@pytest.mark.parametrize("geometry", ["cosmo_mock", "clustered_dense"])
def test_fof3d_matches_reference(geometry):
    pos, vel, mass, boxsize = _mock() if geometry == "cosmo_mock" \
        else _clustered()
    opt = _opts(boxsize, len(pos), fofbgtype=C.FOF3D)
    want = _jax_search(opt, pos, vel, mass, boxsize)
    got = _port_search(opt, pos, vel, mass, boxsize)
    assert got.ngroups == want.ngroups > 0
    np.testing.assert_array_equal(got.pfof.numpy(), np.asarray(want.pfof))


def test_fixpoint_terminates_only_on_jump_validated_rounds():
    """Port of tests/test_fof.py:183.  Chains 5->4->0 and 3->1 over the
    symmetric links (0,4),(4,5),(5,3),(3,1) are hook-stable -- each slot's
    parent already holds the minimum over its neighbours' labels -- yet
    compress to TWO roots for one component.  The exit must be validated
    by pointer jumps, not by the hook alone."""
    erow = torch.tensor([0, 4, 4, 5, 5, 3, 3, 1])
    ecol = torch.tensor([4, 0, 5, 4, 3, 5, 1, 3])

    def sweep_fn(labels):
        return torch.full((6,), TF.BIG_I32, dtype=torch.int64).scatter_reduce(
            0, erow, labels[ecol], "amin")

    empty = torch.zeros(0, dtype=torch.int64)
    labels0 = torch.tensor([0, 1, 2, 1, 0, 4])
    labels, sweeps = TF._fixpoint(sweep_fn, empty, empty, labels0)
    labels = labels.tolist()
    assert len({labels[i] for i in (0, 1, 3, 4, 5)}) == 1
    assert labels[2] == 2
    assert sweeps >= 2


@pytest.fixture(scope="module")
def mock_searches():
    """Reference field searches on the cosmo mock, one per 6D mode."""
    pos, vel, mass, boxsize = _mock()
    out = {}
    for name, fofbg, keep in (("FOF6D", C.FOF6D, 0),
                              ("FOF6DADAPTIVE", C.FOF6DADAPTIVE, 0),
                              ("iKeepFOF", C.FOF6D, 1)):
        opt = _opts(boxsize, len(pos), fofbg, keep)
        out[name] = (opt, _jax_search(opt, pos, vel, mass, boxsize))
    return (pos, vel, mass, boxsize), out


@pytest.mark.parametrize("mode", ["FOF6D", "FOF6DADAPTIVE", "iKeepFOF"])
def test_fof6d_matches_reference(mock_searches, mode):
    (pos, vel, mass, boxsize), runs = mock_searches
    opt, want = runs[mode]
    got = _port_search(opt, pos, vel, mass, boxsize)
    assert want.ngroups3d > 0
    assert got.ngroups3d == want.ngroups3d
    np.testing.assert_array_equal(got.pfof3d.numpy(),
                                  np.asarray(want.pfof3d))
    vs_w = np.asarray(want.vscale2, np.float64)
    vs_g = got.vscale2.numpy().astype(np.float64)
    assert np.max(np.abs(vs_g - vs_w) / vs_w) < 1e-5
    assert got.ngroups == want.ngroups > 0
    np.testing.assert_array_equal(got.pfof.numpy(), np.asarray(want.pfof))
    assert got.num3dfof == want.num3dfof
    if mode == "iKeepFOF":
        assert got.num3dfof > 0
        np.testing.assert_array_equal(got.parent3d.numpy(),
                                      np.asarray(want.parent3d))
    # the 6D stage alone, fed the reference's 3DFOF ids and velocity scales
    pfof3 = convert.group_ids(want.pfof3d)
    vs = convert.per_particle_scale(want.vscale2)
    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    fof6 = TF.SweepFof(_t(pos), _t(vel), boxsize, b3d).subset(pfof3 > 0)
    pfof6, ng6 = fof6.fof6d(b3d * opt.ellhalo6dxfac, pfof3, vs,
                            opt.HaloMinSize)
    fed = thalos.finish_6d(convert.options(opt), pfof3, want.ngroups3d,
                           pfof6, ng6, vs)
    assert fed.ngroups == want.ngroups
    np.testing.assert_array_equal(fed.pfof.numpy(), np.asarray(want.pfof))


def test_vscale_matches_oracle_and_bug_compat():
    """Port of tests/test_oracles.py:108 for the port's velocity scales."""
    rng = np.random.default_rng(52)
    n = 5000
    vel = rng.normal(0, 70.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(1.0, 3.0, n).astype(np.float32)
    pfof = rng.integers(0, 4, n).astype(np.int64)
    fac = 1.25
    tv, tm, tp = _t(vel), _t(mass), _t(pfof)
    got = thalos.velocity_scale_per_group(tv, tm, tp, 4, fac).numpy()
    want = oracles.vscale_oracle(vel, mass, pfof, 3, fac, adaptive=True)
    jgot = np.asarray(jhalos.velocity_scale_per_group(
        jnp.asarray(vel), jnp.asarray(mass), jnp.asarray(pfof, jnp.int32),
        4, fac))
    for g in range(1, 4):
        assert abs(got[g] - want[g]) / want[g] < 1e-4
        assert abs(got[g] - jgot[g]) / jgot[g] < 1e-5
    got1 = float(thalos.velocity_scale_largest_group(tv, tm, tp, 4, fac))
    want1 = oracles.vscale_oracle(vel, mass, pfof, 3, fac,
                                  adaptive=False)[1]
    assert abs(got1 - want1) / want1 < 1e-4
    gotb = float(thalos.velocity_scale_largest_group(tv, tm, tp, 4, fac,
                                                     bug_compat=True))
    wantb = oracles.vscale_oracle(vel, mass, pfof, 3, fac, adaptive=False,
                                  reproduce_reference_bug=True)[1]
    jgotb = float(jhalos.velocity_scale_largest_group(
        jnp.asarray(vel), jnp.asarray(mass), jnp.asarray(pfof, jnp.int32),
        4, fac, bug_compat=True))
    assert abs(gotb - wantb) / wantb < 1e-3
    assert abs(gotb - jgotb) / jgotb < 1e-5
    assert abs(gotb - got1) / got1 > 0.5
