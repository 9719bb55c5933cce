"""The comparison holds the genesis configuration
(``examples/genesis2019_configuration.cfg``) to its own semantics: the
adaptive 6D field search (``FoF_Field_search_type=3``) and the SO of each
field halo's FOF particles (``Inclusive_halo_masses=2``).  On a small
copy of that configuration on the CPU: the sound program passes, and a
program that takes the largest group's 6D scale for every group, one that
computes the SO of all particles, and the control each fail.  Beside it,
the two cells' numbers pinned as the comparison gave them before these
paths existed."""

import json
import time

import pytest

from benchmark import faults
from benchmark.harness import registry, runner
from benchmark.harness.options import build_options
from benchmark.reference import checks, control
from benchmark.tests.tiny import REPO, tiny_root

CELL = "genesis.z6"
# the shipped config has no cosmology of its own (the snapshot's header
# gives it): dmcosmo's lines
COSMOLOGY = ["h_val=1.0", "Omega_m=0.3", "Omega_Lambda=0.7",
             "Critical_density=1.0"]


def genesis_root(dest, n_side: int = 48, n_halo: int = 300, **cfg):
    """``tiny_root`` with one more cell, ``genesis.z6``: the genesis
    config (its shipped lines, dmcosmo's cosmology, ``cfg`` overriding
    keys) on EAGLE L0050N0752's spacing at ``n_side`` particles a side,
    under ``z6_dark`` at ``n_halo`` halos, held to dmcosmo.z6's limits
    and ``fof6d_wrong`` 0."""
    root = tiny_root(dest, n_side, n_halo)
    lines = [ln.strip() for ln in (REPO / "examples" /
                                   "genesis2019_configuration.cfg")
             .read_text().splitlines()
             if "=" in ln and not ln.startswith("#")]
    lines = [ln for ln in lines if ln.split("=")[0] not in cfg]
    lines += COSMOLOGY + [f"{k}={v}" for k, v in cfg.items()]
    bench = root / "benchmark"
    (bench / "configs" / "genesis.json").write_text(json.dumps({
        "boxsize": 50.0 * n_side / 752, "n_side": n_side,
        "species": ["dark_matter"], "reduced": [], "cfg": lines}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "genesis",
                                "file": "benchmark/configs/genesis.json"})
    manifest["workloads"].append({"name": CELL, "config": "genesis",
                                  "traffic": "z6_dark", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    limits = json.loads((bench / "limits" / "dmcosmo.z6.json").read_text())
    limits["limits"]["fof6d_wrong"] = 0
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return genesis_root(tmp_path_factory.mktemp("genesis"))


def numbers_of(cell, seed, catalog=runner._catalog):
    snap = cell.generator(cell.config, cell.traffic, seed, "cpu")
    prm = checks.Params(cell.config, snap.boxsize, snap.n, snap.a)
    cand = catalog(build_options(cell.config, snap, snap.n),
                   runner.to_host(snap), "cpu")
    return checks.compare(snap, prm, cand)


def test_the_sound_program_holds_to_the_genesis_semantics(root):
    c = registry.find_cell(CELL, root)
    numbers = numbers_of(c, 2 ** 31 + 41)
    assert numbers["fof6d_wrong"] == 0
    assert numbers["so_off_share"] < 0.02
    assert all(numbers[k] <= lim for k, lim in c.limits.items()), numbers


@pytest.mark.parametrize("fault", ["adaptive_scale_global",
                                   "so_all_particles"])
def test_a_genesis_fault_makes_the_run_not_correct(root, fault, monkeypatch,
                                                   capsys):
    faults.PATCHES[fault](monkeypatch.setattr)
    rc = runner.run(CELL, 2 ** 31 + 43, 0.5, False, time.perf_counter(),
                    root=root, device="cpu")
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
    number = "fof6d_wrong" if fault == "adaptive_scale_global" else \
        "so_off_share"
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_the_control_fails_the_genesis_numbers(root):
    c = registry.find_cell(CELL, root)
    snap = c.generator(c.config, c.traffic, 2 ** 31 + 47, "cpu")
    prm = checks.Params(c.config, snap.boxsize, snap.n, snap.a)
    numbers = checks.compare(snap, prm, control.build(control.lowered(snap),
                                                      prm))
    assert numbers["fof6d_wrong"] > 0
    assert numbers["so_off_share"] > c.limits["so_off_share"]


@pytest.mark.parametrize("search", [3, 4, 5])
def test_the_reference_groups_stand_in_where_trees_are_not_groups(
        tmp_path, search):
    """With Bound_halos=1 the field halos are unbound before the recursion,
    so the trees are not the FOF groups: the SO of each field halo is
    taken from the reference's group (6D, or 3D for a 3D search) that
    holds its tree."""
    r = genesis_root(tmp_path, Bound_halos=1, FoF_Field_search_type=search)
    c = registry.find_cell(CELL, r)
    prm = checks.Params(c.config, 1.0, 1, 1.0)
    assert not prm.trees_are_groups
    numbers = numbers_of(c, 2 ** 31 + 53)
    assert numbers.get("fof6d_wrong", 0) == 0
    assert numbers["so_off_share"] < 0.02


# compare's numbers on the two cells' small copies (seed 2**31 + 23), as
# the comparison gave them before FOF6DADAPTIVE and the FOF-particle SO
# had paths of their own: a program catalog and the control
PINNED = {
    "dmcosmo.z6": {
        "program": {
            "fof3d_wrong": 0.0, "fof_ambiguous_pairs": 29.0,
            "hierarchy_wrong": 0.0, "props_gap": 9.449681726551697e-06,
            "centre_gap": 0.0011789701636477298, "centre_off_share": 0.0,
            "so_off_share": 0.0, "unbound_share": 0.10057471264367816,
            "subhalos_missed": 0.375, "hosts_missed": 0.0},
        "control": {
            "fof3d_wrong": 20970.0, "fof_ambiguous_pairs": 29.0,
            "hierarchy_wrong": 0.0, "props_gap": 0.0021557013413918925,
            "centre_gap": 1.0, "centre_off_share": 0.9953703703703703,
            "so_off_share": 0.16018518518518518, "unbound_share": 0.0,
            "subhalos_missed": 1.0, "hosts_missed": 1.0}},
    "swifthydro6d.z6": {
        "program": {
            "fof3d_wrong": 0.0, "fof_ambiguous_pairs": 18.0,
            "fof6d_wrong": 0.0, "hierarchy_wrong": 0.0,
            "props_gap": 1.532793982043742e-05,
            "centre_gap": 0.020032686411532993,
            "centre_off_share": 0.009900990099009901, "so_off_share": 0.0,
            "unbound_share": 0.0004561410467445412,
            "subhalos_missed": 0.375, "hosts_missed": 0.33333333333333337,
            "baryons_wrong": 1.0, "baryons_missed": 0.005564325177584846},
        "control": {
            "fof3d_wrong": 22594.0, "fof_ambiguous_pairs": 18.0,
            "fof6d_wrong": 5087.0, "hierarchy_wrong": 0.0,
            "props_gap": 0.0026965996034144925,
            "centre_gap": 1.1239556434952254, "centre_off_share": 1.0,
            "so_off_share": 0.14285714285714285,
            "unbound_share": 0.10073293043590073, "subhalos_missed": 1.0,
            "hosts_missed": 1.0, "baryons_wrong": 1919.0,
            "baryons_missed": 0.15499537261469304}},
}


@pytest.fixture(scope="module")
def cells_root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_the_cells_numbers_are_as_pinned(cells_root, cell):
    c = registry.find_cell(cell, cells_root)
    snap = c.generator(c.config, c.traffic, 2 ** 31 + 23, "cpu")
    prm = checks.Params(c.config, snap.boxsize, snap.n, snap.a)
    assert not prm.adaptive6d and prm.inclusive == 3
    got = {
        "program": checks.compare(snap, prm, runner._catalog(
            build_options(c.config, snap, snap.n), runner.to_host(snap),
            "cpu")),
        "control": checks.compare(snap, prm, control.build(
            control.lowered(snap), prm))}
    for kind, want in PINNED[cell].items():
        assert list(got[kind]) == list(want), kind
        assert got[kind] == want, kind
