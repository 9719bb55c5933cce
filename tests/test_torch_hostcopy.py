"""The port's copies of the JAX package's host modules behave as the
originals: options and config parsing, the mock, the gadget reader and
writer, ``convert.options``, the float64 oracles, the velocity-density
cache and the substructure search's host (numpy) functions.

Each test feeds the same input to both packages and asks for equal results
(exact: the copies are the same numpy code)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from velociraptor_stf_tpu.io import gadget as jgadget
from velociraptor_stf_tpu.io import synthetic as jsynthetic
from velociraptor_stf_tpu.utils import config as JC
from velociraptor_stf_tpu.utils import units as junits
from velociraptor_stf_tpu.validation import oracles as joracles

from velociraptor_stf_tpu_torch import convert
from velociraptor_stf_tpu_torch.io import gadget as tgadget
from velociraptor_stf_tpu_torch.io import synthetic as tsynthetic
from velociraptor_stf_tpu_torch.utils import config as TC
from velociraptor_stf_tpu_torch.utils import units as tunits
from velociraptor_stf_tpu_torch.validation import oracles as toracles
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "examples").glob("*.cfg"))


def test_examples_exist():
    assert len(CONFIGS) >= 5


@pytest.mark.parametrize("name", CONFIGS)
def test_config_parses_equal(name):
    """Every example config gives equal Options through both config
    modules, after config_check and the cosmology set-up."""
    path = str(REPO / "examples" / name)
    want = JC.config_check(JC.parse_config_file(path))
    got = TC.config_check(TC.parse_config_file(path))
    junits.calc_cosmo_params(want, want.a)
    tunits.calc_cosmo_params(got, got.a)
    assert type(got) is TC.Options
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.unknown_keys == want.unknown_keys


@pytest.mark.parametrize("n,nhalos,seed", [(4096, 6, 3), (12 ** 3 * 8, 16, 11),
                                           (20000, 64, 7)])
def test_cosmo_mock_bit_equal(n, nhalos, seed):
    want = jsynthetic.make_cosmo_mock(n, boxsize=25.0, nhalos=nhalos,
                                      seed=seed)
    got = tsynthetic.make_cosmo_mock(n, boxsize=25.0, nhalos=nhalos,
                                     seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gadget_round_trip(tmp_path, writer):
    """A snapshot written by one package reads back equal through both
    readers, including the mass table path (equal masses per type)."""
    rng = np.random.default_rng(4)
    n = 3000
    pos = rng.uniform(0, 50.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 100.0, (n, 3)).astype(np.float32)
    ptype = np.where(np.arange(n) < 2500, 1, 4).astype(np.int8)
    mass = np.where(ptype == 1, 0.5, rng.uniform(0.01, 0.1, n)).astype(
        np.float32)
    ids = rng.permutation(n).astype(np.int64) + 1
    snap = str(tmp_path / "snap")
    mod = jgadget if writer == "jax" else tgadget
    mod.write_gadget(snap, pos, vel, ids, ptype, mass, boxsize=50.0,
                     time=0.5, omega0=0.3, omega_lambda=0.7, hubble=0.7)
    for parttypes in (None, [1]):
        want = jgadget.read_gadget(snap, parttypes=parttypes)
        got = tgadget.read_gadget(snap, parttypes=parttypes)
        assert dataclasses.asdict(got[0]).keys() == \
            dataclasses.asdict(want[0]).keys()
        for key, w in dataclasses.asdict(want[0]).items():
            np.testing.assert_array_equal(dataclasses.asdict(got[0])[key], w,
                                          err_msg=key)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
        sel = slice(None) if parttypes is None else ptype == 1
        np.testing.assert_array_equal(got[1], pos[sel])


def _perturbed(obj):
    """A copy of the dataclass ``obj`` with every field changed: numbers
    moved, flags flipped, strings and lists extended, nested dataclasses
    perturbed in turn."""
    out = type(obj)()
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _perturbed(v)
        elif isinstance(v, bool):
            v = not v
        elif isinstance(v, int):
            v = v + 3
        elif isinstance(v, float):
            v = v * 1.5 + 0.25
        elif isinstance(v, str):
            v = v + "_x"
        elif isinstance(v, list):
            v = list(v) + [1.25]
        elif v is None:
            v = 7
        else:
            raise TypeError(f"{f.name}: {type(v).__name__}")
        setattr(out, f.name, v)
    return out


@pytest.mark.parametrize("name", ["defaults", "perturbed"] + CONFIGS)
def test_convert_options_round_trips(name):
    """convert.options carries every field, nested ones included, into a
    separate port Options."""
    if name == "defaults":
        jopt = JC.Options()
    elif name == "perturbed":
        jopt = _perturbed(JC.Options())
        assert dataclasses.asdict(jopt) != dataclasses.asdict(JC.Options())
    else:
        jopt = JC.config_check(JC.parse_config_file(
            str(REPO / "examples" / name)))
    jopt.nsnapread = 2                  # an attribute the CLI sets
    got = convert.options(jopt)
    assert type(got) is TC.Options
    assert type(got.uinfo) is TC.UnbindInfo
    assert type(got.pinfo) is TC.PropInfo
    assert dataclasses.asdict(got) == dataclasses.asdict(jopt)
    assert got.nsnapread == 2
    # what the hydro path reads
    for key in ("iBaryonSearch", "partsearchtype", "ellhalophysfac",
                "ellhalovelfac", "HaloVelDispScale", "zoomlowmassdm",
                "lengthtokpc", "ParticleTypeForRefenceFrame"):
        assert getattr(got, key) == getattr(jopt, key), key
    # a deep copy: changing one side leaves the other
    if got.aperture_values_kpc is not None:
        got.aperture_values_kpc.append(9.0)
        assert got.aperture_values_kpc != jopt.aperture_values_kpc
    got.uinfo.eps = -1.0
    assert jopt.uinfo.eps != -1.0
    u = convert.unbind_info(jopt.uinfo)
    assert type(u) is TC.UnbindInfo
    assert dataclasses.asdict(u) == dataclasses.asdict(jopt.uinfo)


# the small case of tests/test_oracles.py:257 (FOF6D, Bound_halos=1)
_BOX, _N = 25.0, 12 ** 3 * 8


@pytest.fixture(scope="module")
def oracle_inputs():
    """Each oracle's arguments along the JAX oracle chain on the small
    case, with the JAX oracle's result."""
    pos, vel, mass = jsynthetic.make_cosmo_mock(_N, boxsize=_BOX, nhalos=16,
                                                seed=11)
    opt = JC.Options()
    opt.ellphys, opt.ellxscale = 0.2, _BOX / _N ** (1 / 3)
    opt.fofbgtype, opt.MinSize, opt.HaloMinSize = JC.FOF6D, 20, 32
    opt.uinfo.unbindflag, opt.iBoundHalos = 1, 1
    opt.G, opt.uinfo.Eratio = 43.0211349, 1.0
    JC.config_check(opt)
    b3d = opt.ellphys * opt.ellxscale * opt.ellhalophysfac
    minsize = opt.HaloMinSize
    calls = {}

    def call(name, *args, **kw):
        calls[name] = (args, kw, getattr(joracles, name)(*args, **kw))
        return calls[name][2]

    pfof3, ng3 = call("fof3d_partition_oracle", pos, b3d, _BOX, minsize)
    assert ng3 > 0
    vs = call("vscale_oracle", vel, mass, pfof3, ng3, opt.ellhalo6dvfac,
              adaptive=False)
    pfof6, ng6 = call("fof6d_partition_oracle", pos, vel, pfof3,
                      b3d * opt.ellhalo6dxfac, float(vs[1]), _BOX, minsize)
    # the largest 6D group through unwrap and unbind
    idx = np.nonzero(pfof6 == 1)[0]
    pg = call("unwrap_group_oracle", pos[idx], _BOX)
    alive = call("unbind_oracle", pg, vel[idx], mass[idx],
                 eps=opt.uinfo.eps, G=opt.G, Eratio=opt.uinfo.Eratio,
                 maxunbindfrac=opt.uinfo.maxunbindfrac, min_size=minsize,
                 bgpot=opt.uinfo.bgpot)
    raw = np.where(pfof6 > 0, pfof6, -1 - np.arange(len(pfof6)))
    raw[idx[~alive]] = -1 - idx[~alive]
    call("renumber_by_size_oracle", raw, minsize, tiebreak="label")
    # the SO crossing about the group's centre of mass
    m = mass[idx].astype(np.float64)
    cm = np.sum(pg * m[:, None], 0) / m.sum()
    rhocrit = 1e-4
    call("so_oracle", np.linalg.norm(pg - cm, axis=1), m,
         [np.log(200.0 * rhocrit), np.log(500.0 * rhocrit)],
         max(int(0.05 * len(idx) + 1), 2))
    return calls


def _assert_equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", [
    "fof3d_partition_oracle", "vscale_oracle", "fof6d_partition_oracle",
    "unwrap_group_oracle", "unbind_oracle", "renumber_by_size_oracle",
    "so_oracle"])
def test_oracle_copy_matches(oracle_inputs, name):
    args, kw, want = oracle_inputs[name]
    _assert_equal(getattr(toracles, name)(*args, **kw), want)


def test_new_oracle_copies_match():
    """outlier_fit_oracle and core_growth_oracle, copied with the
    substructure search, on their tests/test_oracles.py inputs."""
    rng = np.random.default_rng(17)
    n = 20000
    side = rng.uniform(size=n) < 0.6 / 1.7
    R = np.where(side, 0.4 - np.abs(rng.normal(0, 0.6, n)),
                 0.4 + np.abs(rng.normal(0, 1.1, n)))
    R[:n // 50] = rng.uniform(4.0, 8.0, n // 50)
    for skewfit in (True, False):
        _assert_equal(toracles.outlier_fit_oracle(R, np.ones(n),
                                                  skewfit=skewfit),
                      joracles.outlier_fit_oracle(R, np.ones(n),
                                                  skewfit=skewfit))
    rng = np.random.default_rng(23)
    pos = np.concatenate([rng.normal(0, 0.1, (200, 3)),
                          rng.normal(0.8, 0.1, (150, 3)),
                          rng.normal(0.4, 0.4, (300, 3))])
    vel = np.concatenate([rng.normal(0, 40, (200, 3)),
                          rng.normal(100, 30, (150, 3)),
                          rng.normal(50, 60, (300, 3))])
    core = np.concatenate([np.ones(200), np.full(150, 2),
                           np.zeros(300)]).astype(np.int32)
    args = (pos, vel, np.ones(650), np.ones(650, bool),
            np.zeros(650, np.int32), core, 2)
    _assert_equal(toracles.core_growth_oracle(*args, iters=3),
                  joracles.core_growth_oracle(*args, iters=3))


def test_density_cache_copy_matches(tmp_path):
    """io/cache.py: either package reads what the other wrote, and both
    refuse a cache of other particles."""
    from velociraptor_stf_tpu.io import cache as jcache
    from velociraptor_stf_tpu_torch.io import cache as tcache

    rng = np.random.default_rng(1)
    dens = rng.uniform(1, 2, 500).astype(np.float32)
    pids = np.sort(rng.choice(10000, 500, replace=False))
    for w, r in ((jcache, tcache), (tcache, jcache)):
        path = str(tmp_path / f"{w.__name__}.localden")
        w.write_local_velocity_density(path, dens, pids)
        np.testing.assert_array_equal(
            r.read_local_velocity_density(path, pids), dens)
        assert r.read_local_velocity_density(path, pids[1:]) is None
        assert r.read_local_velocity_density(path + "x", pids) is None
        groups = {"l1g1": dens[:10]}
        w.write_density_cache(path + "2", groups, pids)
        got = r.read_density_cache(path + "2", pids)
        np.testing.assert_array_equal(got["l1g1"], groups["l1g1"])


@pytest.mark.parametrize("name", ["_group_phase_stats",
                                  "merge_substructures_cores_phase",
                                  "merge_substructures_phase",
                                  "adjust_to_cm", "virial_quantities"])
def test_host_function_copies_match(name):
    """The host (numpy) functions copied into the port: the three phase
    merges' pieces and the single-halo scalings, on one input."""
    from velociraptor_stf_tpu.models import haloprops as JH
    from velociraptor_stf_tpu.models import substructure as JS
    from velociraptor_stf_tpu_torch.models import haloprops as TH
    from velociraptor_stf_tpu_torch.models import substructure as TS

    rng = np.random.default_rng(7)
    n = 1200
    pos = (rng.normal(0, 0.1, (n, 3)) +
           rng.integers(0, 4, (n, 1)) * np.array([0.15, 0, 0])
           ).astype(np.float32)
    vel = rng.normal(0, 20, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    pfof = rng.integers(0, 5, n).astype(np.int32)
    if name == "_group_phase_stats":
        args = (pos, vel, mass, pfof, 4)
    elif name in ("merge_substructures_cores_phase",
                  "merge_substructures_phase"):
        args = (pos, vel, mass, pfof, 2, 2, 3.0)
    elif name == "adjust_to_cm":
        args = (pos, vel, mass)
    else:
        *_, r_s, mcum = JH.adjust_to_cm(pos, vel, mass)
        args = (r_s, mcum, [0.99 * r_s[0], 0.1, 1.01 * r_s[-1]], 1.0,
                200.0)
    mod_j, mod_t = (JS, TS) if not name.startswith(("adjust", "virial")) \
        else (JH, TH)
    _assert_equal(getattr(mod_t, name)(*args), getattr(mod_j, name)(*args))
