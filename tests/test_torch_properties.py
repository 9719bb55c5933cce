"""The port's property stage (velociraptor_stf_tpu_torch/models/
properties.py) against the JAX package's on the same inputs: the JAX
search's group ids and potentials are carried over with
``convert.group_ids`` / ``convert.potential``.

Tolerances: the same keys and shapes; integer columns exact; float columns
within rtol 2e-3, atol 2e-3 * max|want| (the golden tolerance,
tests/test_golden_writers.py:204-205); eigenvectors up to the sign of each
vector.  As in the golden gate (tests/test_golden_writers.py:268-285) the
RVmax_* block is held on the groups whose r < Rmax selection has the same
count: a particle at r = Rmax flips with an ulp of its radius, which the
two frameworks round differently (XLA may contract the sum of squares).
cNFW is held on the groups where the reference's 30-step Newton iteration
(velociraptor_stf_tpu/models/properties.py:297-302) settles.  Its step
uses 0.216 c/(1+c)^2 in place of the derivative, overshoots and often
oscillates; its last iterate then depends on the last ulp of every step
(float32 and float64 numpy end 1% apart), so no two implementations agree
on it.  The Plummer case of tests/test_oracles.py against the float64 SO
oracle: 5e-3.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from velociraptor_stf_tpu.io.synthetic import make_cosmo_mock
from velociraptor_stf_tpu.models import halos as jhalos
from velociraptor_stf_tpu.models import properties as JP
from velociraptor_stf_tpu.models import unbind as JU
from velociraptor_stf_tpu.utils import config as C
from velociraptor_stf_tpu.validation import oracles

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.models import properties as TP
from torch_threads import one_torch_thread  # noqa: F401

CFG = "examples/sample_dmcosmological_run.cfg"
EIGVEC_KEYS = ("geigvec", "RVmax_eigvec")


def slice_options(boxsize, n, **over):
    """The slice's options: the property and output block of the sample
    cosmological config with the bench's search options (FOF6D,
    Bound_halos=1, no substructure)."""
    opt = C.parse_config_file(str(Path(__file__).resolve().parents[1] /
                                  CFG))
    opt.ellphys = 0.2
    opt.ellxscale = boxsize / n ** (1 / 3)
    opt.fofbgtype = C.FOF6D
    opt.MinSize = 20
    opt.HaloMinSize = 32
    opt.uinfo.unbindflag = 1
    opt.iBoundHalos = 1
    opt.uinfo.Eratio = 1.0
    opt.iSubSearch = 0
    opt.iIterateCM = 0
    opt.ibinaryout = C.OUTBINARY
    for k, v in over.items():
        setattr(opt, k, v)
    C.config_check(opt)
    return opt


def newton_settled(vv):
    """True where cNFW does not come from the reference's Newton iteration
    (VmaxVvir2 outside (1.05, 36]), or where that iteration, run in
    float64, has settled: its 30th and 31st iterates agree to 1e-4."""
    vv = np.asarray(vv, np.float64)
    c = np.full(vv.shape, 10.0)
    last = []
    for _ in range(31):
        conec = c / (1.0 + c)
        y = vv - 0.216 * c / (np.log1p(c) - c / (1.0 + c))
        dy = 0.216 * conec * conec / np.maximum(c, 1e-6)
        c = np.clip(c + y / np.maximum(dy, 1e-12), 1.0, 1000.0)
        last = [last[-1], c] if last else [c]
    newton = (vv > 1.05) & (vv <= 36.0)
    return ~newton | (np.abs(last[1] - last[0]) <= 1e-4 * last[1])


def assert_props_match(got, want, ng):
    """Port properties (tensors or numpy) against the JAX package's, rows
    0..ng."""
    assert set(got) == set(want)

    def rows(d, k):
        v = d[k]
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return v[:ng + 1]

    stable = np.ones(ng + 1, bool)
    if "RVmax_npart" in want:
        n_got, n_want = rows(got, "RVmax_npart"), rows(want, "RVmax_npart")
        stable = n_got == n_want
        assert np.abs(n_got.astype(np.int64) - n_want).max() <= 1
        assert stable[1:].mean() >= 0.8, np.nonzero(~stable)
    settled = np.ones(ng + 1, bool)
    if "cNFW" in want:
        settled = newton_settled(rows(want, "VmaxVvir2"))
    for k in sorted(want):
        g, w = rows(got, k), rows(want, k)
        assert g.shape == w.shape, k
        if k.startswith("RVmax_"):
            g, w = g[stable], w[stable]
        if k == "cNFW":
            g, w = g[settled], w[settled]
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        if k in EIGVEC_KEYS or k.startswith("eigvec_"):
            # each eigenvector (column) up to its sign
            sign = np.sign(np.sum(g * w, axis=-2, keepdims=True))
            g = g * np.where(sign == 0, 1.0, sign)
        scale = np.abs(w).max(initial=0.0)
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=2e-3 * max(scale, 1e-30),
                                   err_msg=k)


@pytest.fixture(scope="module")
def searched():
    """The JAX search + field unbind of a periodic mock: pfof and W."""
    boxsize, n = 32.0, 1 << 15
    pos, vel, mass = make_cosmo_mock(n, boxsize=boxsize, nhalos=60, seed=9)
    opt = slice_options(boxsize, n)
    fres = jhalos.search_full_set(opt, jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(mass), boxsize=boxsize)
    ures = JU.check_unbound_groups(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), fres.pfof,
        fres.ngroups, opt.uinfo, opt.G, boxsize=boxsize,
        min_size=opt.HaloMinSize)
    assert ures.ngroups >= 8
    return (pos, vel, mass, np.asarray(ures.pfof), ures.ngroups,
            np.asarray(ures.W), boxsize)


CASES = [(C.PROPREFCM, 0, True), (C.PROPREFMBP, 1, True),
         (C.PROPREFMINPOT, 0, True), (C.PROPREFMINPOT, 1, False),
         (C.PROPREFCM, 1, False), (C.PROPREFMBP, 0, False)]


@pytest.mark.parametrize("ref,iterate,periodic", CASES,
                         ids=[f"ref{r}-it{i}-{'periodic' if p else 'open'}"
                              for r, i, p in CASES])
def test_property_bundle_matches_reference(searched, ref, iterate,
                                           periodic):
    pos, vel, mass, pfof, ng, W, boxsize = searched
    box = boxsize if periodic else None
    opt = slice_options(boxsize, len(pos), iPropertyReferencePosition=ref,
                        iIterateCM=iterate)
    want = JP.property_bundle(opt, jnp.asarray(pos), jnp.asarray(vel),
                              jnp.asarray(mass), jnp.asarray(pfof), ng,
                              W=jnp.asarray(W), boxsize=box)
    got = TP.property_bundle(convert.options(opt), torch.from_numpy(pos),
                             torch.from_numpy(vel), torch.from_numpy(mass),
                             convert.group_ids(pfof), ng,
                             W=convert.potential(W), boxsize=box)
    for key in ("Mass_profile", "RVmax_q", "Aperture_mass_1", "Efrac",
                "Projected_aperture_0_mass_proj2", "cNFW"):
        assert key in got
    assert_props_match(got, want, ng)


def test_compute_properties_without_shape(searched):
    """The member-only SO pass of Inclusive_halo_masses 1/2 (no shape,
    default centre and frame)."""
    pos, vel, mass, pfof, ng, _, boxsize = searched
    kw = dict(G=43.0211349, boxsize=boxsize, rhocrit=3.0, rhobg=1.0,
              so_thresholds=(100.0, 2500.0), calc_shape=False)
    want = JP.compute_properties(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(mass), jnp.asarray(pfof), ng,
                                 **kw)
    got = TP.compute_properties(torch.from_numpy(pos),
                                torch.from_numpy(vel),
                                torch.from_numpy(mass),
                                convert.group_ids(pfof), ng, **kw)
    assert "gq" not in got
    assert_props_match(got, want, ng)


def test_stage_functions_match_reference_in_any_order(searched):
    """The aperture, RVmax and energy stages called on their own with the
    particles shuffled: each sorts by group itself."""
    pos, vel, mass, pfof, ng, W, boxsize = searched
    perm = np.random.default_rng(1).permutation(len(pos))
    pos, vel, mass, pfof, W = (a[perm] for a in (pos, vel, mass, pfof, W))
    jarr = [jnp.asarray(a) for a in (pos, vel, mass, pfof)]
    tarr = [torch.from_numpy(a) for a in (pos, vel, mass)] + \
        [convert.group_ids(pfof)]
    core = JP.compute_properties(*jarr, ng, boxsize=boxsize)
    refpos, refvel = np.array(core["gcm"]), np.array(core["gcmvel"])
    rmax = np.array(core["gRmaxvel"])
    jref = dict(refpos=jnp.asarray(refpos), refvel=jnp.asarray(refvel))
    tref = dict(refpos=torch.from_numpy(refpos),
                refvel=torch.from_numpy(refvel))
    ap = dict(apertures=(0.05, 0.3), apertures_proj=(0.2,),
              profile_edges=(-1.5, -1.0, -0.5, 0.0), iprofilenorm=0)
    want = dict(JP.compute_aperture_properties(
        *jarr, ng, R200c=core["gR200c"], **jref, **ap))
    want.update(JP.compute_rvmax_properties(*jarr, ng, rmax=jnp.asarray(rmax),
                                            **jref))
    want.update(JP.compute_energies(jarr[1], jarr[2], jarr[3],
                                    jnp.asarray(W), ng, jref["refvel"],
                                    jnp.float32(0.95)))
    got = dict(TP.compute_aperture_properties(
        *tarr, ng, R200c=torch.from_numpy(np.array(core["gR200c"])),
        **tref, **ap))
    got.update(TP.compute_rvmax_properties(*tarr, ng,
                                           rmax=torch.from_numpy(rmax),
                                           **tref))
    got.update(TP.compute_energies(tarr[1], tarr[2], tarr[3],
                                   convert.potential(W), ng, tref["refvel"],
                                   0.95))
    assert "Mass_profile" in got and "Aperture_rhalfmass_1" in got
    assert_props_match(got, want, ng)


def test_pertype_not_ported(searched):
    """Once the per-type blocks were refused; now ``pertype`` without
    particle types adds no column (as in the reference), and with them the
    per-type blocks (held to the reference in tests/test_torch_pertype.py)."""
    pos, vel, mass, pfof, ng, W, boxsize = searched
    args = (convert.options(slice_options(boxsize, len(pos))),
            torch.from_numpy(pos), torch.from_numpy(vel),
            torch.from_numpy(mass), convert.group_ids(pfof), ng)
    plain = TP.property_bundle(*args)
    assert set(TP.property_bundle(*args, pertype=True)) == set(plain)
    ptype = torch.ones(len(pos), dtype=torch.int64)
    ptype[::5] = 0
    typed = TP.property_bundle(*args, pertype=True, ptype=ptype)
    assert set(plain) < set(typed)
    np.testing.assert_array_equal(
        typed["n_gas"][1:].numpy(),
        np.bincount(pfof[::5], minlength=ng + 1)[1:])
    assert int(typed["n_star"].sum()) == 0


def test_so_crossing_matches_oracle():
    """tests/test_oracles.py:36-65: a Plummer halo, f32 vectorised SO
    crossings against the sequential float64 oracle, < 0.5%."""
    rng = np.random.default_rng(50)
    n = 20000
    a, mtot = 0.5, 1000.0
    r = a / np.sqrt(rng.uniform(0.05, 1.0, n) ** (-2 / 3) - 1.0 + 1e-9)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = r[:, None] * u
    vel = rng.normal(0, 1.0, (n, 3)) * 0.3 * np.sqrt(mtot / n)
    mass = np.full(n, mtot / n)
    rhocrit = 0.1
    pr = TP.compute_properties(
        torch.from_numpy(pos.astype(np.float32)),
        torch.from_numpy(vel.astype(np.float32)),
        torch.from_numpy(mass.astype(np.float32)),
        torch.ones(n, dtype=torch.int64), 1, rhocrit=rhocrit,
        rhobg=0.3 * rhocrit, iIterateCM=False, min_size=20)
    cm = np.sum(pos * mass[:, None], 0) / mass.sum()
    radii = np.linalg.norm(pos - cm, axis=1)
    minnum = max(int(0.05 * n + 1), int(20 * 0.05 + 1))
    thr = [np.log(200.0 * rhocrit), np.log(500.0 * rhocrit),
           np.log(200.0 * 0.3 * rhocrit)]
    (R200c, R500c, R200m), (M200c, M500c, M200m) = oracles.so_oracle(
        radii, mass, thr, minnum)
    for key, want in (("gM200c", M200c), ("gM500c", M500c),
                      ("gM200m", M200m), ("gR200c", R200c),
                      ("gR500c", R500c), ("gR200m", R200m)):
        got = float(pr[key][1])
        assert want > 0
        assert abs(got - want) / want < 5e-3, (key, got, want)


def test_segment_cumsum_is_per_segment_exact():
    """The running total is float64: a small group after 2^24 unit masses
    keeps its exact cumulative masses in float32 (a float32 running total
    would have lost the unit steps)."""
    from velociraptor_stf_tpu_torch.ops import segments as seg

    big = 1 << 24
    g = torch.cat([torch.ones(big, dtype=torch.int64),
                   torch.full((5,), 2, dtype=torch.int64)])
    v = torch.cat([torch.ones(big), torch.tensor([0.5, 1.0, 1.0, 1.0, 1.0])])
    offs = seg.group_offsets(g, 2)
    cs = seg.segment_cumsum(v, g, offs)
    assert cs[big:].tolist() == [0.5, 1.5, 2.5, 3.5, 4.5]
    assert float(cs[big - 1]) == float(big)
