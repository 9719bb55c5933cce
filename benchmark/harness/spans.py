"""The program's spans of the traced catalogs, and the device trace's
events put down to them by time.

While a ``torch.profiler`` session is active the program records spans
(``velociraptor_stf_tpu_torch/utils/timing.py``: ``spans()``), each with
its ``name``, the id of its ``catalog`` (the ``find_structures`` call it
lies in) and ``t0_ns`` / ``t1_ns`` on the host clock that the profiler
stamps its events with.  So a host call or a device operation of the
trace lies in a span when its time does.  A program that records no
spans gives nothing here, and its readers report nothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from benchmark.harness.trace import DeviceTrace, _merged
from benchmark.spread import WAITS

# host calls that launch a kernel (runtime and driver API)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


class Catalogs:
    """The spans of the catalogs that lie in the trace's window."""

    def __init__(self, trace: DeviceTrace, records: List[dict]):
        self.trace = trace
        self.records = records
        self.n = sum(r["name"] == "catalog" for r in records)

    def intervals(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(start, end) seconds of the spans called ``name``, by start."""
        sel = sorted((r["t0_ns"], r["t1_ns"]) for r in self.records
                     if r["name"] == name)
        if not sel:
            return np.zeros(0), np.zeros(0)
        a = np.asarray(sel, np.float64) * 1e-9
        return a[:, 0], a[:, 1]

    def count(self, name: str) -> float:
        """Spans called ``name`` a catalog."""
        return sum(r["name"] == name for r in self.records) / self.n

    def host_calls(self, name: str, kind: str) -> float:
        """Host calls of ``kind`` ("waits" or "launches") starting inside
        the spans called ``name``, a catalog."""
        s, e = self.intervals(name)
        calls = _host_starts(self.trace, kind)
        return float(_inside(calls, s, e).sum()) / self.n

    def idle_share(self, name: str) -> float:
        """100 x (1 - the union of the device operations inside the spans
        called ``name`` / their total length), on several cards taken
        card by card and averaged over the cell's cards; 0 where no such
        span lasted (no time, so none idle)."""
        s, e = self.intervals(name)
        total = float((e - s).sum())
        if total <= 0:
            return 0.0
        shares = []
        for ds, de in self.trace.per_card():
            ms, me = _merged(ds, de)
            busy = 0.0
            for a, b in zip(s, e):
                busy += float(np.clip(np.minimum(me, b) - np.maximum(ms, a),
                                      0, None).sum())
            shares.append(100.0 * (1.0 - busy / total))
        return shares[0] if len(shares) == 1 else float(np.mean(shares))


def traced(ctx) -> Optional[Catalogs]:
    """The catalogs whose ``catalog`` span lies in ``ctx.trace``'s window
    (by its middle), with every span of theirs; None without a trace, or
    without spans from the program."""
    tr = ctx.trace
    if tr is None:
        return None
    try:
        from velociraptor_stf_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    if read is None:
        return None
    records = read()
    ids = {r["id"] for r in records if r["name"] == "catalog" and
           tr.t0 <= 0.5e-9 * (r["t0_ns"] + r["t1_ns"]) <= tr.t1}
    if not ids:
        return None
    return Catalogs(tr, [r for r in records if r["catalog"] in ids])


_KINDS = {"waits": lambda n: n in WAITS,
          "launches": lambda n: n.startswith(LAUNCHES)}
_cache: dict = {}


def _host_starts(tr: DeviceTrace, kind: str) -> np.ndarray:
    """Start times of the trace's host calls of ``kind``, kept for the
    trace last asked about."""
    if _cache.get("trace") is not tr:
        _cache.clear()
        _cache["trace"] = tr
    if kind not in _cache:
        sel = np.fromiter(map(_KINDS[kind], tr.host_names), bool,
                          len(tr.host_names))
        _cache[kind] = np.asarray(tr.host_start, np.float64)[sel]
    return _cache[kind]


def _inside(t: np.ndarray, s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Which of the times ``t`` lie in one of the disjoint intervals
    [s, e], sorted by start."""
    if not len(s) or not len(t):
        return np.zeros(len(t), bool)
    k = np.searchsorted(s, t, side="right") - 1
    ok = k >= 0
    return ok & (t <= e[np.clip(k, 0, None)])
