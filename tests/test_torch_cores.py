"""The port's merger-core search (velociraptor_stf_tpu_torch/models/
substructure.py: ``search_cores_batch`` and ``_phase_tensor_growth_batch``
of one structure) and the two host phase merges against the JAX
package's (``halo_core_search``, ``_phase_tensor_growth``): core ids
exactly equal on tests/test_cores.py's two-core mock, the phase-tensor
growth against the float64 oracle as tests/test_oracles.py:178 holds the
JAX package to it, and the merges on tests/test_merging.py's inputs with
``coresubmergemindist`` > 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.validation.oracles import core_growth_oracle

from test_cores import merger_mock
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _alone(opt, pos, vel, mass, valid, sub, level=1):
    """``search_cores_batch`` of one structure over its rows' extent (the
    grid the JAX search takes without bounds): (core ids, ncores)."""
    p = _t(pos)
    b = p.double()
    e = {"ppos": p, "pvel": _t(vel), "pmass": _t(mass), "valid": _t(valid),
         "sub": _t(sub).long(), "nsub": len(pos), "npad": len(pos),
         "bounds": (b.amin(0).numpy(), b.amax(0).numpy())}
    (core, nc), = TS.search_cores_batch(convert.options(opt), [e], level)
    assert core.dtype == torch.int64
    return core, nc


def _core_opts(**over):
    """tests/test_cores.py's sample-config core options."""
    opt = C.Options()
    opt.ellphys, opt.ellxscale = 0.2, 0.5
    opt.iHaloCoreSearch = 2
    opt.halocorexfac = 0.7
    opt.halocorevfac = 2.0
    opt.halocorenfac = 0.005
    opt.halocorenumloops = 8
    opt.halocorexfaciter = 0.75
    opt.halocorevfaciter = 1.0
    opt.halocorenumfaciter = 1.2
    opt.MinSize = 20
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


@pytest.mark.parametrize("case", ["merger", "tagged", "rebuild",
                                  "no_growth", "level2"])
def test_halo_core_search_matches_reference(case):
    pos, vel, mass, member2 = merger_mock()
    n = len(pos)
    sub = np.zeros(n, np.int32)
    over, level = {}, 1
    if case == "tagged":            # particles of a substructure stay out
        sub[member2 & (np.arange(n) % 3 == 0)] = 1
    elif case == "rebuild":         # a growing length
        over = {"halocorexfaciter": 1.05, "halocorenumloops": 3}
    elif case == "no_growth":
        over = {"iPhaseCoreGrowth": 0}
    elif case == "level2":
        level = 2
    opt = _core_opts(**over)
    valid = np.ones(n, bool)
    want, nc_want = JS.halo_core_search(opt, pos, vel, mass, valid, sub,
                                        sublevel=level)
    got, nc = _alone(opt, pos, vel, mass, valid, sub, level)
    assert nc == nc_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "merger":
        assert nc >= 2 and (got.numpy() > 0).all()


def test_single_core_null():
    """A relaxed single-component halo yields no extra cores, as in the
    JAX package (tests/test_cores.py)."""
    rng = np.random.default_rng(3)
    n = 3000
    sigma = np.sqrt(43.0211349 * 100.0 / 6)
    pos = rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    vel = rng.normal(0, sigma, (n, 3)).astype(np.float32)
    mass = np.full(n, 100.0 / n, np.float32)
    opt = _core_opts()
    valid = np.ones(n, bool)
    want, nc_want = JS.halo_core_search(opt, pos, vel, mass, valid,
                                        np.zeros(n, np.int32))
    got, nc = _alone(opt, pos, vel, mass, valid, np.zeros(n, np.int32))
    assert nc == nc_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _growth_input():
    """tests/test_oracles.py:178's two cores with free particles."""
    rng = np.random.default_rng(23)
    n1, n2, nfree = 700, 400, 2000
    c1p = rng.normal(0, 0.08, (n1, 3))
    c1v = rng.normal(0, 40.0, (n1, 3))
    c2p = np.array([0.9, 0, 0]) + rng.normal(0, 0.05, (n2, 3))
    c2v = np.array([0, 120.0, 0]) + rng.normal(0, 25.0, (n2, 3))
    fp = np.concatenate([rng.normal(0, 0.3, (nfree // 2, 3)),
                         np.array([0.9, 0, 0]) +
                         rng.normal(0, 0.2, (nfree // 2, 3))])
    fv = np.concatenate([rng.normal(0, 60.0, (nfree // 2, 3)),
                         np.array([0, 120.0, 0]) +
                         rng.normal(0, 40.0, (nfree // 2, 3))])
    pos = np.concatenate([c1p, c2p, fp]).astype(np.float32)
    vel = np.concatenate([c1v, c2v, fv]).astype(np.float32)
    core0 = np.concatenate([np.ones(n1), np.full(n2, 2),
                            np.zeros(nfree)]).astype(np.int32)
    return pos, vel, np.ones(len(pos), np.float32), core0, n1 + n2


def test_phase_tensor_growth_matches_oracle_and_reference():
    pos, vel, mass, core0, nseed = _growth_input()
    n = len(pos)
    valid = np.ones(n, bool)
    sub = np.zeros(n, np.int32)
    got = TS._phase_tensor_growth_batch(
        _t(pos), _t(vel), _t(mass), _t(valid), _t(sub).long(),
        _t(core0).long(), torch.zeros(n, dtype=torch.int64),
        torch.tensor([2]), 2, 3, iters=4).numpy()
    want = core_growth_oracle(pos, vel, mass, valid, sub, core0, 2, iters=4)
    np.testing.assert_array_equal(got[:nseed], want[:nseed])
    assert (got != want).mean() < 0.01
    jax_core = np.asarray(JS._phase_tensor_growth(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(valid), jnp.asarray(sub), jnp.asarray(core0), 2,
        iters=4))
    np.testing.assert_array_equal(got, jax_core)


def test_core_sub_phase_merge_matches_reference():
    """tests/test_merging.py::test_core_sub_phase_merge's input."""
    rng = np.random.default_rng(2)
    n = 400
    sub = rng.normal(0, 0.05, (n, 3))
    core_near = rng.normal(0, 0.05, (n, 3))
    core_far = np.array([3.0, 0, 0]) + rng.normal(0, 0.05, (n, 3))
    pos = np.concatenate([sub, core_near, core_far]).astype(np.float32)
    vel = rng.normal(0, 10.0, pos.shape).astype(np.float32)
    vel[2 * n:] += 500.0
    mass = np.ones(len(pos), np.float32)
    pfof = np.concatenate([np.full(n, 1), np.full(n, 2),
                           np.full(n, 3)]).astype(np.int32)
    for fdist in (2.0, 0.5, 0.0):
        want = JS.merge_substructures_cores_phase(pos, vel, mass, pfof, 1, 2,
                                                  fdist)
        got = TS.merge_substructures_cores_phase(pos, vel, mass, pfof, 1, 2,
                                                 fdist)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert TS.merge_substructures_cores_phase(pos, vel, mass, pfof, 1, 2,
                                              2.0)[1] == 1


def test_subs_phase_merge_matches_reference():
    rng = np.random.default_rng(3)
    n = 400
    a = rng.normal(0, 0.05, (n, 3))
    b = rng.normal(0, 0.05, (n, 3))
    c = np.array([5.0, 0, 0]) + rng.normal(0, 0.05, (n, 3))
    pos = np.concatenate([a, b, c]).astype(np.float32)
    vel = rng.normal(0, 10.0, pos.shape).astype(np.float32)
    mass = np.ones(len(pos), np.float32)
    pfof = np.concatenate([np.full(n, 1), np.full(n, 2),
                           np.full(n, 3)]).astype(np.int32)
    for numsubs, numcores in ((3, 0), (2, 1), (1, 2)):
        want = JS.merge_substructures_phase(pos, vel, mass, pfof, numsubs,
                                            numcores, 2.0)
        got = TS.merge_substructures_phase(pos, vel, mass, pfof, numsubs,
                                           numcores, 2.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_recursion_with_cores_and_merges_matches_reference():
    """search_sub_sub with the merger-core search and both phase merges
    (coresubmergemindist > 0) on the two-core mock as one field halo."""
    pos, vel, mass, _ = merger_mock()
    opt = _core_opts(iSubSearch=1, iiterflag=1, ellthreshold=2.5,
                     Vratio=2.0, thetaopen=0.1, coresubmergemindist=1.0,
                     G=43.0211349)
    opt.ellxscale = 0.25
    opt.uinfo.unbindflag = 0
    pfof = np.ones(len(pos), np.int32)
    want = JS.search_sub_sub(opt, pos, vel, mass, pfof.copy(), 1)
    got = TS.search_sub_sub(convert.options(opt), pos, vel, mass,
                            pfof.copy(), 1)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3], want[3])
