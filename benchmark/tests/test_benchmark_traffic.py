"""The snapshot generator: the same halo sizes for every seed, the same
snapshot for one seed."""

import json

import numpy as np
import pytest
import torch

from benchmark.tests.tiny import tiny_root
from benchmark.traffic import cosmo_box


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def load(root, config, traffic):
    cfg = json.loads((root / "benchmark/configs" / f"{config}.json")
                     .read_text())
    tr = json.loads((root / "benchmark/traffic" / f"{traffic}.json")
                    .read_text())
    return cfg, tr


@pytest.mark.parametrize("config,traffic", [("dmcosmo", "z6_dark"),
                                            ("swifthydro6d", "z6_hydro")])
def test_same_sizes_for_every_seed(root, config, traffic):
    cfg, tr = load(root, config, traffic)
    a = cosmo_box.generate(cfg, tr, 1, "cpu")
    b = cosmo_box.generate(cfg, tr, 2 ** 31 + 12345, "cpu")
    assert np.array_equal(a.halo_sizes, b.halo_sizes)
    assert np.array_equal(a.sub_sizes, b.sub_sizes)
    assert a.n == b.n
    assert not torch.equal(a.pos, b.pos)
    if a.ptype is not None:
        assert torch.equal(torch.bincount(a.ptype.long()),
                           torch.bincount(b.ptype.long()))


@pytest.mark.parametrize("config,traffic", [("dmcosmo", "z6_dark"),
                                            ("swifthydro6d", "z6_hydro")])
def test_same_snapshot_for_one_seed(root, config, traffic):
    cfg, tr = load(root, config, traffic)
    a = cosmo_box.generate(cfg, tr, 77, "cpu")
    b = cosmo_box.generate(cfg, tr, 77, "cpu")
    for k in ("pos", "vel", "mass", "ptype", "sub_of"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None and y is None) or torch.equal(x, y)
    assert a.extras.keys() == b.extras.keys()
    for k in a.extras:
        assert torch.equal(a.extras[k], b.extras[k])
    assert float(a.pos.min()) >= 0 and float(a.pos.max()) < a.boxsize


def test_cell_sizes_as_the_traffic_states():
    """The full cells' populations, as both z6 mixes state them: 1,000
    halos with 11 hosts of >= 800 (1.4% of 188^3 in halos)."""
    for mix in ("z6_dark", "z6_hydro"):
        t = json.loads((tiny_root.__globals__["REPO"] / "benchmark/traffic"
                        / f"{mix}.json").read_text())
        s = cosmo_box.quantile_sizes(t["n_halo"], t["m_min"], t["m_max"],
                                     t["slope"])
        assert len(s) == 1000 and s.max() == 1175
        assert (s >= t["sub_min_host"]).sum() == 11
        assert abs(s.sum() / 188 ** 3 - 0.0141) < 1e-3


def test_subhalo_sizes_hold_up_to_the_share():
    for n in (800, 5000, 116598):
        s = cosmo_box.subhalo_sizes(n, 0.1, 20, 1.9)
        assert 0.75 * round(0.1 * n) <= s.sum() <= round(0.1 * n)
        assert s.min() >= 20
    hosts = cosmo_box.quantile_sizes(1000, 20, 1200, 1.9)
    subs = [cosmo_box.subhalo_sizes(int(n), 0.1, 20, 1.9)
            for n in hosts[hosts >= 800]]
    assert sum(len(x) for x in subs) == 33
    assert sum(int((x >= 30).sum()) for x in subs) == 19


def test_particle_masses_are_the_mean_density():
    cfg = json.loads((tiny_root.__globals__["REPO"] /
                      "benchmark/configs/swifthydro6d.json").read_text())
    e = cosmo_box.cfg_numbers(cfg)
    m = cosmo_box.particle_masses(cfg, e)
    assert m["gas"] / m["dark_matter"] == pytest.approx(0.05 / 0.25)
    rho_c = 3 * 100.0 ** 2 / (8 * np.pi * e["Gravity"])
    assert m["dark_matter"] * 188 ** 3 == pytest.approx(
        0.25 * rho_c * 12.5 ** 3)


@pytest.mark.parametrize("config,traffic", [("dmcosmo", "z6_dark"),
                                            ("swifthydro6d", "z6_hydro")])
def test_every_seed_draws_the_same_halos(root, config, traffic):
    """With a halo_seed, a planted subhalo's particles lie and move the
    same way about its centre for every seed; only where it is differs."""
    cfg, tr = load(root, config, traffic)
    assert "halo_seed" in tr

    def subhalo(seed):
        s = cosmo_box.generate(cfg, tr, seed, "cpu")
        sel = s.sub_of == 0
        p, v = s.pos[sel].double(), s.vel[sel].double()
        d = p - p[0]
        d = d - s.boxsize * torch.round(d / s.boxsize)
        rel = torch.cat([d - d.mean(0), v - v.mean(0)], 1)
        return torch.sort(rel, dim=0).values, p.mean(0)

    (a, ca), (b, cb) = subhalo(3), subhalo(2 ** 31 + 77)
    # float32 rounding at different places in the box: 1e-6 of the box
    # in position, 1e-3 km/s in velocity
    tol = torch.tensor([1e-6 * cfg["boxsize"]] * 3 + [1e-3] * 3,
                       dtype=torch.float64)
    assert ((a - b).abs() <= tol).all()
    assert not torch.allclose(ca, cb)


def place_every(rng, radii, box, gap):
    """Halo centres tested against every centre placed before."""
    centres = np.zeros((len(radii), 3))
    for i, r in enumerate(radii):
        while True:
            c = rng.uniform(0.0, box, 3)
            d = centres[:i] - c
            d -= box * np.round(d / box)
            if np.all((d * d).sum(1) > (radii[:i] + r + gap) ** 2):
                break
        centres[i] = c
    return centres


@pytest.mark.parametrize("n,box", [(300, 1.0), (2000, 1.0), (50, 0.05)])
def test_halos_are_placed_as_against_every_centre(n, box):
    # the largest radius 0.01: a grid of 48 cells a side, and (box 0.05)
    # a box too small for three cells, which tests every centre
    radii = np.sort(np.random.default_rng(n).uniform(0.001, 0.01, n))[::-1]
    got = cosmo_box._place(np.random.default_rng(1), radii, box, 0.0005)
    want = place_every(np.random.default_rng(1), radii, box, 0.0005)
    assert np.array_equal(got, want)
