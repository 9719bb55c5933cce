"""A small copy of the benchmark's files for CPU tests: the same cells,
configurations and traffic mixes with the volume and the number of
halos cut (the particle spacing, the halos' sizes up to the mixes' own
largest, their profiles, subhalos and the configs stay)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]


def tiny_root(dest: Path, n_side: int = 48, n_halo: int = 300,
              chips: Optional[int] = None) -> Path:
    """Copy BENCHMARK.json and benchmark/ under ``dest`` with every
    configuration at ``n_side`` particles a side and every traffic mix at
    ``n_halo`` halos: at 300, three hosts of >= 800 particles (the
    recursion's size) with planted subhalos, a quarter of 48^3 in
    halos; with ``chips``, every cell on that many cards."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        w["chips"] = chips or w["chips"]
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dest / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        frac = n_side / c["n_side"]
        c["boxsize"] *= frac
        c["n_side"] = n_side
        f.write_text(json.dumps(c))
    for f in (dest / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["n_halo"] = n_halo
        f.write_text(json.dumps(t))
    return dest
