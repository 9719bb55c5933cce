"""The port's main path (velociraptor_stf_tpu_torch.models.pipeline.
search_and_unbind: 3DFOF -> 6DFOF -> field unbind) against the JAX
package's stages and against the independent float64 oracle chain, and the
modes neither entry point has ported yet.

Group ids and counts must be exactly equal; potentials within rel 1e-4.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import halos as jhalos
from velociraptor_stf_tpu.models import unbind as JU
from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.utils import units
from velociraptor_stf_tpu.validation import oracles

from velociraptor_stf_tpu_torch.models.pipeline import (find_structures,
                                                       search_and_unbind)


def _bench_opts(boxsize, n, **over):
    """bench.py's options (FOF6D, Bound_halos=1, no substructure)."""
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF6D
    opt.MinSize = 20
    opt.HaloMinSize = 32
    opt.uinfo.unbindflag = 1
    opt.iBoundHalos = 1
    opt.uinfo.Eratio = 1.0
    opt.G = 43.0211349
    opt.iSubSearch = 0
    opt.iIterateCM = 0
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


def _reference_slice(opt, pos, vel, mass, boxsize):
    """The JAX package's metric stages: search_full_set, then the field
    unbind as find_structures calls it."""
    units.calc_cosmo_params(opt, opt.a)
    fres = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(mass), boxsize=boxsize)
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    ures = JU.check_unbound_groups(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), fres.pfof,
        fres.ngroups, opt.uinfo, opt.G, boxsize=boxsize, min_size=minsize)
    return fres, ures


def test_slice_matches_reference_stages():
    boxsize = 32.0
    n = 1 << 15
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=20, seed=7)
    fres, ures = _reference_slice(_bench_opts(boxsize, n), pos, vel, mass,
                                  boxsize)
    res = search_and_unbind(_bench_opts(boxsize, n), pos, vel, mass,
                            boxsize=boxsize, device="cpu")
    np.testing.assert_array_equal(res.pfof3d.numpy(),
                                  np.asarray(fres.pfof3d))
    assert res.ngroups == ures.ngroups > 0
    np.testing.assert_array_equal(res.pfof.numpy(), np.asarray(ures.pfof))
    W0 = np.asarray(ures.W, np.float64)
    W1 = res.W.numpy().astype(np.float64)
    nz = W0 != 0
    assert np.array_equal(W1[~nz], W0[~nz])
    assert np.max(np.abs(W1[nz] - W0[nz]) / np.abs(W0[nz])) < 1e-4
    assert set(res.timings) == {"fof", "unbind"}


def _oracle_chain(pos, vel, mass, opt, boxsize):
    """tests/test_oracles.py::_e2e_oracle_chain: FOF3D -> vscale -> 6DFOF
    -> per-group unbind -> renumber, entirely in float64 numpy/scipy."""
    minsize = opt.HaloMinSize if opt.HaloMinSize > 0 else opt.MinSize
    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    pfof3, ng3 = oracles.fof3d_partition_oracle(pos, b3d, boxsize, minsize)
    if ng3 == 0:
        return pfof3, 0
    vs = oracles.vscale_oracle(vel, mass, pfof3, ng3, opt.ellhalo6dvfac,
                               adaptive=False)
    pfof6, ng6 = oracles.fof6d_partition_oracle(
        pos, vel, pfof3, b3d * opt.ellhalo6dxfac, float(vs[1]), boxsize,
        minsize)
    bound = np.zeros(len(pfof6), bool)
    for g in range(1, ng6 + 1):
        idx = np.nonzero(pfof6 == g)[0]
        pg = oracles.unwrap_group_oracle(pos[idx], boxsize)
        alive = oracles.unbind_oracle(
            pg, vel[idx], mass[idx], eps=opt.uinfo.eps, G=opt.G,
            Eratio=opt.uinfo.Eratio,
            maxunbindfrac=opt.uinfo.maxunbindfrac, min_size=minsize,
            bgpot=opt.uinfo.bgpot)
        bound[idx[alive]] = True
    raw = np.where(bound, pfof6, -1 - np.arange(len(pfof6)))
    relab, ng = oracles.renumber_by_size_oracle(raw, minsize,
                                                tiebreak="label")
    return np.where(raw > 0, relab, 0), ng


def test_slice_matches_f64_oracle_chain():
    """The case of tests/test_oracles.py:257: exact partition."""
    boxsize = 25.0
    n = 12 ** 3 * 8
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=16, seed=11)
    res = search_and_unbind(_bench_opts(boxsize, n), pos, vel, mass,
                            boxsize=boxsize, device="cpu")
    want, ng_want = _oracle_chain(pos, vel, mass, _bench_opts(boxsize, n),
                                  boxsize)
    assert res.ngroups == ng_want > 0
    np.testing.assert_array_equal(res.pfof.numpy(), want)


def test_slice_keepfof_envelopes():
    """iKeepFOF: envelopes are split off and re-attached around the field
    unbind (which config_check turns off with iKeepFOF)."""
    boxsize = 25.0
    n = 1 << 14
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=6, seed=7)
    opt = _bench_opts(boxsize, n, iKeepFOF=1)
    assert opt.iBoundHalos == 0
    want = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(mass), boxsize=boxsize)
    res = search_and_unbind(_bench_opts(boxsize, n, iKeepFOF=1), pos, vel,
                            mass, boxsize=boxsize, device="cpu")
    assert want.num3dfof > 0
    assert res.ngroups == want.ngroups
    np.testing.assert_array_equal(res.pfof.numpy(), np.asarray(want.pfof))
    assert res.W is None and "unbind" not in res.timings


@pytest.mark.parametrize("what", ["iSubSearch", "iSingleHalo", "baryons",
                                  "mesh", "pertype"])
def test_unported_modes_raise(what):
    """Both entry points refuse the modes not ported yet; per-type
    properties (several particle types without a baryon search) concern
    only find_structures."""
    pos = np.zeros((8, 3), np.float32)
    opt = _bench_opts(10.0, 8)
    kw = {}
    if what == "iSubSearch":
        opt.iSubSearch = 1
    elif what == "iSingleHalo":
        opt.iSingleHalo = 1
    elif what == "baryons":
        opt.iBaryonSearch = 1
        kw["ptype"] = np.array([C.DARKTYPE] * 4 + [0] * 4)
    elif what == "pertype":
        kw["ptype"] = np.array([C.DARKTYPE] * 4 + [4] * 4)
    else:
        kw["mesh"] = object()
    args = (opt, pos, pos, np.ones(8, np.float32))
    if what != "pertype":
        with pytest.raises(NotImplementedError):
            search_and_unbind(*args, boxsize=10.0, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        find_structures(*args, boxsize=10.0, device="cpu", **kw)


def test_non_periodic_box_matches_reference():
    """boxsize None: no ghosts, grid bounded by the particles."""
    pos, vel, mass = make_cosmo_mock(1 << 13, boxsize=20.0, nhalos=8,
                                     seed=21)
    keep = np.all((pos > 2.0) & (pos < 18.0), axis=1)
    pos, vel, mass = pos[keep], vel[keep], mass[keep]
    n = len(pos)
    fres, ures = _reference_slice(_bench_opts(20.0, n), pos, vel, mass,
                                  None)
    res = search_and_unbind(_bench_opts(20.0, n), pos, vel, mass,
                            boxsize=None, device="cpu")
    assert res.ngroups == ures.ngroups > 0
    np.testing.assert_array_equal(res.pfof.numpy(), np.asarray(ures.pfof))


@pytest.mark.parametrize("n", [1, 50, 3000])
@pytest.mark.parametrize("boxsize", [10.0, None])
def test_slice_without_groups(n, boxsize):
    """Sparse uniform points: no group, nothing to unbind."""
    pos = np.random.default_rng(n).uniform(0, 10, (n, 3)).astype(np.float32)
    res = search_and_unbind(_bench_opts(10.0, 3000), pos, pos,
                            np.ones(n, np.float32), boxsize=boxsize,
                            device="cpu")
    assert res.ngroups == 0 and res.W is None
    assert tuple(res.pfof.shape) == (n,) and int(res.pfof.abs().sum()) == 0
