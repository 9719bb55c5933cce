"""Everything of a cell is found by name: the manifest at the checkout's
root names the cell's configuration, traffic mix and metrics; each of
those is a file of its own under ``benchmark/``.

- configuration ``<c>``: the file the manifest's entry names
  (``benchmark/configs/<c>.json``);
- traffic mix ``<t>``: ``benchmark/traffic/<t>.json``, whose
  ``generator`` names ``benchmark/traffic/<generator>.py``;
- per-layer metric ``<m>``: ``benchmark/metrics/<m>.py`` with ``read(ctx)``;
- the limits of the cell's comparison: ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path, name: str):
    """Import the file at ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_name: str
    traffic: dict
    traffic_name: str
    generator: Callable
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def manifest(root: Optional[Path] = None) -> dict:
    with open((root or ROOT) / "BENCHMARK.json") as fh:
        return json.load(fh)


def find_cell(name: str, root: Optional[Path] = None) -> Cell:
    root = root or ROOT
    bench = root / "benchmark"
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    with open(root / configs[w["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(bench / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    gen = load_module(bench / "traffic" / f"{traffic['generator']}.py",
                      f"bench_traffic_{traffic['generator']}")
    with open(bench / "limits" / f"{name}.json") as fh:
        limits = json.load(fh)["limits"]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                config_name=w["config"], traffic=traffic,
                traffic_name=w["traffic"], generator=gen.generate,
                end_to_end=[e for e in m["end_to_end"] if _applies(e, name)],
                per_layer=[p for p in m["per_layer"] if _applies(p, name)],
                limits={k: float(v) for k, v in limits.items()})


def metric_reader(name: str, root: Optional[Path] = None) -> Callable:
    """``read(ctx)`` of per-layer metric ``name``."""
    bench = (root or ROOT) / "benchmark"
    mod = load_module(bench / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_"))
    return mod.read
