"""The port's substructure recursion (velociraptor_stf_tpu_torch/models/
substructure.py::search_sub_sub) against the JAX package's on the planted
mocks of tests/test_substructure.py: group ids, group count, hostid,
parent and level exactly equal, with and without the level-wide unbind,
with the per-structure (halo-local) density, and through the velocity
density cache.
"""

import numpy as np
import pytest

from velociraptor_stf_tpu.models import substructure as JS
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io.synthetic import (G_KMS,
                                                     host_with_subhalo,
                                                     planted_subhalos)
from velociraptor_stf_tpu_torch.models import substructure as TS
from velociraptor_stf_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401


def _opts(**over):
    opt = C.Options()
    opt.ellphys = 0.2
    opt.ellxscale = 0.25
    opt.iiterflag = 1
    opt.ellthreshold = 2.5
    opt.Vratio = 2.0
    opt.thetaopen = 0.10
    opt.ellfac = 1.0
    opt.MinSize = 20
    opt.uinfo.unbindflag = 0
    opt.G = G_KMS
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _three_hosts():
    """tests/test_substructure.py:400-421."""
    pos, vel, mass, host = planted_subhalos(3, seed=10)
    return pos, vel, mass, host, 3


def _two_subhalos():
    """tests/test_substructure.py:103: one field halo, two subhalos."""
    rng = np.random.default_rng(42)
    pos, vel, mass, _ = host_with_subhalo(seed=1)
    nsub2 = 500
    sigma = np.sqrt(G_KMS * 100.0 / 6)
    s2pos = np.array([-0.5, 0.2, 0]) + \
        0.05 * rng.normal(size=(nsub2, 3)) / np.sqrt(3)
    s2vel = np.array([0.0, -1.7 * sigma, 0.8 * sigma]) + \
        rng.normal(0, 6.0, (nsub2, 3))
    pos = np.concatenate([pos, s2pos.astype(np.float32)])
    vel = np.concatenate([vel, s2vel.astype(np.float32)])
    mass = np.full(len(pos), 100.0 / len(pos), np.float32)
    return pos, vel, mass, np.ones(len(pos), np.int32), 1


def _assert_same(got, want):
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for k in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


@pytest.mark.parametrize("case,unbind", [("three_hosts", 0),
                                         ("three_hosts", 1),
                                         ("two_subhalos", 0)])
def test_search_sub_sub_matches_reference(case, unbind):
    pos, vel, mass, pfof, ng = (_three_hosts if case == "three_hosts"
                                else _two_subhalos)()
    opt = _opts()
    opt.uinfo.unbindflag = unbind
    want = JS.search_sub_sub(opt, pos, vel, mass, pfof.copy(), ng)
    timings: dict = {}
    telemetry.reset()
    got = TS.search_sub_sub(convert.options(opt), pos, vel, mass,
                            pfof.copy(), ng, timings=timings)
    _assert_same(got, want)
    assert got[1] > ng                              # substructure found
    assert {f"subsub_{p}" for p in ("density", "prep", "outliers", "subset",
                                    "cores", "unbind", "splice")} <= \
        set(timings)
    counts = telemetry.snapshot()
    assert counts["subsub_level1_structures"] == ng
    assert counts["subsub_level1_found"] == int((got[4] == 1).sum())
    if case == "two_subhalos":
        assert int((got[3] == 1).sum()) >= 2


def test_halo_local_density_matches_reference():
    """iHaloLocalDensity = 1: each structure's density from its own padded
    rows (the reference's HALOONLYDEN mode)."""
    pos, vel, mass, pfof, ng = _three_hosts()
    opt = _opts(iHaloLocalDensity=1)
    want = JS.search_sub_sub(opt, pos, vel, mass, pfof.copy(), ng)
    got = TS.search_sub_sub(convert.options(opt), pos, vel, mass,
                            pfof.copy(), ng)
    _assert_same(got, want)


def test_density_cache_roundtrip(tmp_path):
    """Output_den: the first run writes the velocity density, the second
    replays it and gives the same catalog (reference io.cxx:178-251); a
    cache of other particles is not applied."""
    pos, vel, mass, pfof, ng = _three_hosts()
    opt = convert.options(_opts(smname=str(tmp_path / "run.localden")))
    first = TS.search_sub_sub(opt, pos, vel, mass, pfof.copy(), ng)
    assert (tmp_path / "run.localden.npz").exists()
    with np.load(tmp_path / "run.localden.npz") as z:
        dens = z["density"]
        assert len(dens) == int((pfof > 0).sum()) and (dens > 0).all()
    again = TS.search_sub_sub(opt, pos, vel, mass, pfof.copy(), ng)
    np.testing.assert_array_equal(again[0].numpy(), first[0].numpy())
    assert again[1] == first[1]
    np.testing.assert_array_equal(again[3], first[3])
    # the same file for another particle set: the fingerprint refuses it
    # and the density is computed afresh
    sub = pfof.copy()
    sub[:50] = 0
    other = TS.search_sub_sub(opt, pos, vel, mass, sub, ng)
    plain = TS.search_sub_sub(convert.options(_opts()), pos, vel, mass,
                              sub.copy(), ng)
    np.testing.assert_array_equal(other[0].numpy(), plain[0].numpy())


def test_padded_context_matches_reference():
    """The padded structure context: the JAX package's batched device
    build against the port's, unwrap, lattice and CM shift included."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(2)
    n = 5000
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 50, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    dens = rng.uniform(1, 2, n).astype(np.float32)
    order = rng.permutation(n).astype(np.int32)
    starts = np.array([0, 1500, 2900], np.int32)
    nsubs = np.array([1500, 1200, 1100], np.int32)
    sides = np.ceil(np.maximum(2048 - nsubs, 1) ** (1 / 3)).astype(np.int32)
    for box, cm in ((10.0, True), (0.0, False)):
        want = JS._prep_class_device(
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
            jnp.asarray(dens), jnp.asarray(order), jnp.asarray(starts),
            jnp.asarray(nsubs), jnp.asarray(sides), 2048, box, 0.45, cm,
            True)
        got = TS._prep_class(*(torch.from_numpy(a) for a in (
            pos, vel, mass, dens, order.astype(np.int64),
            starts.astype(np.int64), nsubs.astype(np.int64),
            sides.astype(np.int64))), 2048, box, 0.45, cm)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
            else:
                np.testing.assert_array_equal(g, w)
