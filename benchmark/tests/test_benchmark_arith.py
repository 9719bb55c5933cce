"""End-to-end arithmetic and the trace's reduction on synthetic data."""

import numpy as np
import pytest

from benchmark.harness import e2e
from benchmark.harness.trace import DeviceTrace


def test_catalog_rate_counts_whole_catalogs_over_the_window():
    assert e2e.catalog_rate(1000, 3, 2.0) == 1500.0
    with pytest.raises(ValueError):
        e2e.catalog_rate(1000, 0, 2.0)


def test_nearest_rank_p95():
    vals = [float(v) for v in range(1, 101)]
    assert e2e.nearest_rank(vals, 95) == 95.0
    assert e2e.nearest_rank([3.0, 1.0, 2.0], 95) == 3.0
    assert e2e.nearest_rank(list(range(1, 21)), 95) == 19


def test_outside_time_sums_top_level_stages_only():
    t = {"fof": 0.1, "substructure": 0.5, "subsub_cores": 0.4,
         "properties": 0.2, "so": 0.05}
    assert e2e.outside_s(1.0, t) == pytest.approx(0.15)


def test_busy_is_the_union_and_gaps_are_named():
    tr = DeviceTrace(
        names=["k1(int)", "k2", "k1(int)"],
        start=np.array([0.0, 0.5, 2.0]), end=np.array([1.0, 1.5, 2.5]),
        host_names=["outer", "aten::item", "aten::nonzero"],
        host_start=np.array([0.0, 1.6, 2.6]),
        host_end=np.array([3.0, 1.9, 2.9]), t0=0.0, t1=3.0)
    assert tr.busy_s() == pytest.approx(2.0)
    assert tr.window_s() == 3.0
    gaps = tr.idle_gaps(2)
    assert gaps[0] == ("aten::item", pytest.approx(0.5))
    assert gaps[1] == ("aten::nonzero", pytest.approx(0.5))
    assert tr.top_ops(1)[0] == ("k1(int)", pytest.approx(1.5))
    assert tr.kernel_times("k1").sum() == pytest.approx(1.5)
