"""End-to-end arithmetic over the window's whole catalogs."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

# the catalog's top-level stages in find_structures' timings; the
# ``subsub_*`` laps lie inside ``substructure``
STAGES = ("fof", "unbind", "substructure", "baryons", "properties", "so")


def catalog_rate(n_particles: int, n_catalogs: int, window_s: float) -> float:
    """Particles of the snapshot x catalogs completed / the window's time
    from its start to the end of its last catalog."""
    if n_catalogs <= 0 or window_s <= 0:
        raise ValueError("no catalog completed in the window")
    return n_particles * n_catalogs / window_s


def nearest_rank(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile: the ceil(pct/100 * n)-th smallest."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(pct / 100.0 * len(s)))
    return s[k - 1]


def outside_s(wall_s: float, timings: Dict[str, float]) -> float:
    """A catalog's wall time outside its timed stages: the transfer in,
    the copies out and host work between stages."""
    return wall_s - sum(timings.get(k, 0.0) for k in STAGES)


def mean(values: List[float]) -> float:
    return sum(values) / len(values)
