"""The port's per-type properties (velociraptor_stf_tpu_torch/models/
properties.py::compute_pertype_properties and its call in property_bundle)
against the JAX package's on the same numpy inputs, and the hand-over of
particle types and hydro fields from find_structures.

Counts exact; every float key within rtol 2e-3, atol 2e-3 * max|want| (the
golden tolerance); eigenvectors up to the sign of each vector and only
where the type has at least four members in the group (a degenerate
inertia tensor has no unique eigenvectors).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.models import pipeline as JP
from velociraptor_stf_tpu.models import properties as JPR
from velociraptor_stf_tpu.utils import config as C

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import pipeline as TP
from velociraptor_stf_tpu_torch.models import properties as TPR

from test_torch_baryons import BOX, hydro_mock, hydro_options
from test_torch_properties import assert_props_match
from test_torch_subcatalog import accept_ties, half_mass_ties
from torch_threads import one_torch_thread  # noqa: F401

G = 43.0211349
EXTRAS = ("u", "sfr", "zmet", "tage", "bhmdot")


def _ball(rng, n, radius, centre):
    r = radius * rng.random(n) ** (1 / 3)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return centre + d * r[:, None]


def mixed_input(seed=11):
    """Three groups and untagged particles of types 0-5 with unequal
    masses and all five hydro fields; group 3 holds dark matter and gas
    only (no star, no black hole), group 2 two black holes."""
    rng = np.random.default_rng(seed)
    sizes = (1800, 900, 300)
    pos, pfof, ptype = [], [], []
    for g, n in enumerate(sizes, 1):
        pos.append(_ball(rng, n, 0.3, np.full(3, 2.0 * g)))
        pfof.append(np.full(n, g))
        t = rng.choice([0, 1, 2, 3, 4, 5], n,
                       p=[0.25, 0.5, 0.02, 0.02, 0.18, 0.03])
        if g == 3:
            t = np.where(np.isin(t, (4, 5)), 1, t)
        if g == 2:
            t = np.where(t == 5, 1, t)
            t[:2] = 5
        ptype.append(t)
    pos.append(rng.uniform(0, 8, (400, 3)))
    pfof.append(np.zeros(400, int))
    ptype.append(rng.integers(0, 6, 400))
    pos = np.concatenate(pos).astype(np.float32)
    pfof = np.concatenate(pfof).astype(np.int32)
    ptype = np.concatenate(ptype).astype(np.int8)
    n = len(pos)
    perm = rng.permutation(n)
    pos, pfof, ptype = pos[perm], pfof[perm], ptype[perm]
    vel = rng.normal(0, 80, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ex = {"u": rng.uniform(10, 100, n), "zmet": rng.uniform(0, 0.03, n),
          "sfr": np.where(rng.random(n) < 0.4, rng.uniform(0.1, 2, n), 0.0),
          "tage": rng.uniform(0, 10, n), "bhmdot": rng.uniform(0, 1, n)}
    ex = {k: v.astype(np.float32) for k, v in ex.items()}
    refpos = np.stack([np.zeros(3)] + [np.full(3, 2.0 * g) + 0.01
                                       for g in (1, 2, 3)]).astype(np.float32)
    refvel = rng.normal(0, 5, (4, 3)).astype(np.float32)
    radii = {"rvmax": [0, 0.2, 0.15, 0.25], "r200c": [0, 0.25, 0.2, 0.3],
             "r200m": [0, 0.3, 0.3, 0.3], "r500c": [0, 0.1, 0.12, 0.2],
             "rBN98": [0, 0.28, 0.22, 0.26]}
    radii = {k: np.array(v, np.float32) for k, v in radii.items()}
    return pos, vel, mass, ptype, pfof, ex, refpos, refvel, radii


def _run_both(full=True, zoom=0.0, **drop):
    pos, vel, mass, ptype, pfof, ex, refpos, refvel, radii = mixed_input()
    ex = {k: v for k, v in ex.items() if k not in drop}
    radii = {k: v for k, v in radii.items() if k not in drop}
    kw = dict(r30=0.12, r50=0.2, zoomlowmassdm=zoom, full=full)
    want = JPR.compute_pertype_properties(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(ptype), jnp.asarray(pfof), 3,
        refpos=jnp.asarray(refpos), refvel=jnp.asarray(refvel),
        **{k: jnp.asarray(v) for k, v in {**ex, **radii}.items()}, **kw)
    got = TPR.compute_pertype_properties(
        torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(mass),
        torch.from_numpy(ptype).long(), convert.group_ids(pfof), 3,
        refpos=torch.from_numpy(refpos), refvel=torch.from_numpy(refvel),
        **{k: torch.from_numpy(v) for k, v in {**ex, **radii}.items()}, **kw)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_pertype_match(got, want):
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        assert not g[0].any(), k               # the untagged row is zero
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        if k.startswith("eigvec_"):
            ok = want["n_" + k[len("eigvec_"):]] >= 4
            sign = np.sign(np.sum(g * w, axis=-2, keepdims=True))
            g, w = (g * np.where(sign == 0, 1.0, sign))[ok], w[ok]
        scale = np.abs(w).max(initial=0.0)
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=2e-3 * max(scale, 1e-30), err_msg=k)


@pytest.mark.parametrize("case", ["full", "basic", "zoom", "no-extras"])
def test_pertype_keys_match_reference(case):
    kw = {"full": {}, "basic": dict(full=False),
          "zoom": dict(zoom=1.5),
          "no-extras": dict(u=0, sfr=0, zmet=0, tage=0, bhmdot=0,
                            rvmax=0, r500c=0, rBN98=0)}[case]
    want, got = _run_both(**kw)
    _assert_pertype_match(got, want)
    if case == "full":
        for t in ("gas", "star", "bh", "gas_sf", "gas_nsf"):
            for key in ("n_", "M_", "cm_", "cmvel_", "sigV_", "L_",
                        "R_HalfMass_", "MassTwiceRhalfmass_", "veldisp_",
                        "q_", "s_", "eigvec_", "Krot_", "M_200crit_",
                        "L_BN98_"):
                assert key + t in got, key + t
            assert f"M_{t}_rvmax" in got and f"M_{t}_30kpc" in got
        for key in ("Temp_gas", "Temp_mean_gas_sf", "SFR_gas", "SFR_mean_gas",
                    "Zmet_gas_nsf", "Zmet_star", "t_mean_star",
                    "M_bh_mostmassive", "acc_bh", "acc_bh_mostmassive",
                    "n_interloper", "M_interloper", "M_500c_interloper"):
            assert key in got, key
        assert "SFR_gas_nsf" not in got
        # group 3 has neither stars nor black holes: everything is zero,
        # the mass inside twice a half-mass radius of zero included
        assert got["n_star"][3] == 0 and got["n_bh"][3] == 0
        for key in ("MassTwiceRhalfmass_star", "MassTwiceRhalfmass_bh",
                    "M_star", "R_HalfMass_bh", "acc_bh"):
            assert got[key][3] == 0, key
        assert got["n_bh"][2] == 2 and got["n_interloper"][1] > 0
        np.testing.assert_array_equal(got["n_gas_sf"] + got["n_gas_nsf"],
                                      got["n_gas"])
        np.testing.assert_allclose(got["M_gas_sf"] + got["M_gas_nsf"],
                                   got["M_gas"], rtol=1e-5)
    if case == "basic":
        assert "q_gas" not in got and "n_gas_sf" not in got and \
            "n_interloper" not in got
    if case == "zoom":
        full, _ = _run_both()
        assert (got["n_interloper"][1:] > full["n_interloper"][1:]).all()
    if case == "no-extras":
        assert "Temp_gas" not in got and "M_gas_rvmax" not in got and \
            "M_500c_gas" not in got and "M_200crit_gas" in got


def test_pertype_full_property_blocks():
    """The direct assertions of tests/test_baryons.py:157-223 on the
    port: one isotropic group with planted type and SFR counts."""
    rng = np.random.default_rng(11)
    n, Rh = 3000, 0.3
    pos = _ball(rng, n, Rh, np.zeros(3)).astype(np.float32)
    sig = math.sqrt(G * n / Rh) * 0.25
    vel = rng.normal(0, sig, (n, 3)).astype(np.float32)
    ptype = np.ones(n, np.int64)
    ptype[:600] = 0
    ptype[600:900] = 4
    ptype[900:950] = 5
    ptype[950:1000] = 2
    sfr = np.zeros(n, np.float32)
    sfr[:300] = 1.0
    rad = torch.full((2,), Rh)
    out = TPR.compute_pertype_properties(
        torch.from_numpy(pos), torch.from_numpy(vel), torch.ones(n),
        torch.from_numpy(ptype), torch.ones(n, dtype=torch.int64), 1,
        refpos=torch.zeros(2, 3), refvel=torch.zeros(2, 3),
        u=torch.full((n,), 50.0), sfr=torch.from_numpy(sfr),
        zmet=torch.full((n,), 0.02), tage=None,
        bhmdot=torch.full((n,), 0.1), rvmax=rad, r200c=rad, r200m=rad,
        r500c=0.5 * rad, rBN98=None, r30=0.1, r50=0.2)
    out = {k: v.numpy() for k, v in out.items()}
    assert out["n_gas"][1] == 600
    assert out["n_gas_sf"][1] == 300 and out["n_gas_nsf"][1] == 300
    assert out["M_gas_sf"][1] + out["M_gas_nsf"][1] == out["M_gas"][1]
    assert out["SFR_gas"][1] == 300.0
    assert out["n_star"][1] == 300 and out["n_bh"][1] == 50
    assert out["n_interloper"][1] == 50 and out["M_interloper"][1] == 50.0
    assert abs(out["acc_bh"][1] - 5.0) < 1e-4
    assert 0.7 < out["q_gas"][1] <= 1.001
    assert 0.7 < out["s_star"][1] <= 1.001
    assert 0.0 <= out["Krot_gas"][1] < 0.9
    assert out["veldisp_gas"][1].shape == (3, 3)
    assert out["veldisp_gas"][1][0, 0] > 0
    assert out["M_200crit_gas"][1] == out["M_gas"][1]
    assert out["M_500c_gas"][1] < out["M_gas"][1]
    assert out["L_200crit_gas"][1].shape == (3,)
    assert out["M_gas_30kpc"][1] <= out["M_gas_50kpc"][1]
    assert out["MassTwiceRhalfmass_gas"][1] >= 0.5 * out["M_gas"][1]
    assert "t_mean_star" not in out and "L_BN98_gas" not in out


@pytest.fixture(scope="module")
def mock():
    return hydro_mock()


def _both_catalogs(mock, extras=True, **over):
    pos, vel, mass, ptype, ex = mock
    ex = ex if extras else None
    opt = hydro_options(len(pos), **over)
    want = JP.find_structures(opt, pos, vel, mass, boxsize=BOX, ptype=ptype,
                              extras=ex)
    got = TP.find_structures(convert.options(hydro_options(len(pos), **over)),
                             pos, vel, mass, boxsize=BOX, ptype=ptype,
                             extras=ex, device="cpu")
    assert got.ngroups == want.ngroups >= 2
    np.testing.assert_array_equal(got.pfof, np.asarray(want.pfof))
    # F5's rule: the stars' equal masses of 0.6 make ties of the
    # cumulative mass (ROADMAP queue 3)
    ties = half_mass_ties(opt, want.props, pos, mass, got.pfof, W=want.W,
                          vel=vel, ptype=ptype,
                          sfr=None if ex is None else ex["sfr"], boxsize=BOX)
    gp = {k: np.array(v) for k, v in got.props.items()}
    wp = {k: np.array(v) for k, v in want.props.items()}
    accept_ties(gp, wp, ties)
    assert_props_match(gp, wp, got.ngroups)
    return got


def test_several_types_without_baryon_search(mock):
    """Baryon_searchflag=0 with several types: one search over all
    particles, no association, and still the per-type blocks."""
    got = _both_catalogs(mock, iBaryonSearch=0)
    assert "baryons" not in got.timings
    ptype = mock[3]
    assert got.props["n_gas"][1] > 0 and got.props["n_star"][1] > 0
    np.testing.assert_array_equal(
        got.props["n_gas"][1:],
        np.bincount(got.pfof[ptype == 0], minlength=got.ngroups + 1)[1:])
    np.testing.assert_array_equal(
        got.props["num"][1:],
        np.bincount(got.pfof, minlength=got.ngroups + 1)[1:])
    assert "Temp_mean_gas" in got.props and "t_mean_star" in got.props


def test_reference_frame_particle_type_reaches_properties(mock):
    """Particle_type_for_reference_frames = star with the potential
    minimum as the frame: the centre is a star's position, which the
    types handed to the property stage decide; without the hydro fields
    the per-type blocks stay but for those that need them."""
    over = dict(iPropertyReferencePosition=C.PROPREFMINPOT)
    stars = _both_catalogs(mock, extras=False,
                           ParticleTypeForRefenceFrame=C.STARTYPE, **over)
    anytype = TP.find_structures(
        convert.options(hydro_options(len(mock[0]), **over)), *mock[:3],
        boxsize=BOX, ptype=mock[3], device="cpu")
    np.testing.assert_array_equal(stars.pfof, anytype.pfof)
    # half-mass radii are measured from the frame's centre
    assert not np.allclose(stars.props["gRhalfmass"][1:],
                           anytype.props["gRhalfmass"][1:], rtol=1e-6)
    assert "M_gas" in stars.props and "Temp_mean_gas" not in stars.props


def test_single_type_has_no_pertype_columns(mock):
    pos, vel, mass, ptype, _ = mock
    dm = ptype == 1
    got = TP.find_structures(convert.options(hydro_options(int(dm.sum()))),
                             pos[dm], vel[dm], mass[dm], boxsize=BOX,
                             ptype=ptype[dm], device="cpu")
    assert got.ngroups >= 2 and "n_gas" not in got.props
    assert "baryons" not in got.timings
