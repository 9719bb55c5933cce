"""Cells, configurations, traffic mixes, metrics and limits are found by
name, and a new one is picked up from new files and entries alone."""

import json

import pytest

from benchmark.harness import registry
from benchmark.tests.tiny import REPO, tiny_root


def test_every_cell_is_found_by_name():
    m = registry.manifest(REPO)
    for w in m["workloads"]:
        cell = registry.find_cell(w["name"], REPO)
        assert cell.config_name == w["config"]
        assert cell.traffic_name == w["traffic"]
        assert callable(cell.generator)
        assert cell.limits
        names = {e["name"] for e in cell.end_to_end}
        assert {"catalog_rate", "setup_s"} <= names
        for p in cell.per_layer:
            assert callable(registry.metric_reader(p["name"], REPO))


def test_catalog_s_p95_only_where_listed():
    assert "catalog_s_p95" not in {
        e["name"] for e in registry.find_cell("dmcosmo.z6",
                                              REPO).end_to_end}
    assert "catalog_s_p95" in {
        e["name"] for e in registry.find_cell("swifthydro6d.z6",
                                              REPO).end_to_end}


def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    root = tiny_root(tmp_path)
    b = root / "benchmark"
    cfg = json.loads((b / "configs/dmcosmo.json").read_text())
    (b / "configs/dmcosmo_copy.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic/z6_hydro.json").read_text())
    tr.pop("gas_sigma_share")
    (b / "traffic/z6_dm.json").write_text(json.dumps(tr))
    (b / "limits/dmcosmo_copy.z6.json").write_text(
        json.dumps({"limits": {"fof3d_wrong": 0}}))
    (b / "metrics/entry.wall_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx.mean_over_catalogs(lambda wall, t: wall)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="dmcosmo_copy",
                             file="benchmark/configs/dmcosmo_copy.json"))
    m["workloads"].append({"name": "dmcosmo_copy.z6",
                           "config": "dmcosmo_copy", "traffic": "z6_dm",
                           "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "entry.wall_s", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "entry", "moves": "catalog_rate",
                           "workloads": ["dmcosmo_copy.z6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = registry.find_cell("dmcosmo_copy.z6", root)
    assert cell.traffic["a"] == tr["a"]
    assert [p["name"] for p in cell.per_layer][-1] == "entry.wall_s"
    snap = cell.generator(cell.config, cell.traffic, 3, "cpu")
    assert snap.ptype is None and snap.a == pytest.approx(1 / 7)
    read = registry.metric_reader("entry.wall_s", root)

    class Ctx:
        def mean_over_catalogs(self, fn):
            return fn(2.0, {})

    assert read(Ctx()) == 2.0
    with pytest.raises(KeyError):
        registry.find_cell("no.such.cell", root)


def test_manifest_keeps_the_contract_shape():
    m = registry.manifest(REPO)
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).exists()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert p["moves"] in {e["name"] for e in m["end_to_end"]}


def test_configs_hold_the_shipped_configs_as_run():
    """Each configuration's ``cfg`` lines are the shipped config's
    key=value pairs as the port's parser reads them."""
    for name in ("dmcosmo", "swifthydro6d"):
        cfg = json.loads((REPO / f"benchmark/configs/{name}.json")
                         .read_text())
        pairs = []
        for line in (REPO / cfg["shipped_cfg"]).read_text().splitlines():
            if not line or line.startswith("#") or line.find("=") <= 0:
                continue
            k, v = line[:line.find("=")].split(), \
                line[line.find("=") + 1:].split()
            if k and v:
                pairs.append(f"{k[0]}={v[0]}")
        assert cfg["cfg"] == pairs
