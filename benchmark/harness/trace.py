"""The device trace of a few catalogs: ``torch.profiler`` events kept in
memory (no trace file is written), reduced to device operations with
their intervals and cards, the busy time as the union of those intervals
on each card, and the idle gaps named by the host operation running in
each.  On several cards a number of the device is taken card by card
and averaged over the cell's cards: a card that ran nothing counts as
idle the whole window."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class DeviceTrace:
    names: List[str]          # device operation names
    start: np.ndarray         # (n,) seconds, on the host's profiler clock
    end: np.ndarray
    host_names: List[str]     # host operations
    host_start: np.ndarray
    host_end: np.ndarray
    t0: float                 # the traced window on the same clock
    t1: float
    card: Optional[np.ndarray] = None   # (n,) each operation's card index
    cards: int = 1            # the cell's cards, 0..cards-1

    def window_s(self) -> float:
        return self.t1 - self.t0

    def per_card(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(start, end) of each card's operations, cards 0..cards-1; on
        one card every operation."""
        if self.cards == 1:
            return [(self.start, self.end)]
        return [(self.start[self.card == i], self.end[self.card == i])
                for i in range(self.cards)]

    def busy_per_card(self) -> List[float]:
        """Seconds in which some device operation ran on each card: the
        union of its intervals clipped to the window."""
        return [float(_union(np.clip(s, self.t0, self.t1),
                             np.clip(e, self.t0, self.t1)).sum())
                for s, e in self.per_card()]

    def busy_s(self) -> float:
        """The cards' busy seconds, averaged over the cell's cards."""
        busy = self.busy_per_card()
        return busy[0] if len(busy) == 1 else float(np.mean(busy))

    def kernel_times(self, part: str) -> np.ndarray:
        """Durations (s) of the operations whose name contains ``part``."""
        sel = np.array([part in n for n in self.names], bool)
        return (self.end - self.start)[sel] if len(sel) else np.zeros(0)

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        tot = {}
        for n, d in zip(self.names, self.end - self.start):
            short = n[:120]
            tot[short] = tot.get(short, 0.0) + float(d)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The ``k`` longest gaps between device operations in the window,
        each named by the innermost host operation covering its middle;
        on several cards each card's gaps, named with the card first."""
        if self.cards == 1:
            return self._gaps(self.start, self.end, k)
        gaps = []
        for i, (s, e) in enumerate(self.per_card()):
            gaps += [(f"card {i}: {name}", length)
                     for name, length in self._gaps(s, e, k)]
        return sorted(gaps, key=lambda g: -g[1])[:k]

    def _gaps(self, start: np.ndarray, end: np.ndarray, k: int
              ) -> List[Tuple[str, float]]:
        if not len(start):
            return [("no device operation", self.window_s())]
        s, e = _merged(np.clip(start, self.t0, self.t1),
                       np.clip(end, self.t0, self.t1))
        gs = np.concatenate([[self.t0], e])
        ge = np.concatenate([s, [self.t1]])
        length = ge - gs
        order = np.argsort(-length)[:k]
        out = []
        for i in order:
            if length[i] <= 0:
                break
            mid = 0.5 * (gs[i] + ge[i])
            cover = (self.host_start <= mid) & (self.host_end >= mid)
            if cover.any():
                idx = np.nonzero(cover)[0]
                j = idx[np.argmin((self.host_end - self.host_start)[idx])]
                name = self.host_names[j][:120]
            else:
                name = "host outside any profiled operation"
            out.append((name, float(length[i])))
        return out


def _merged(s: np.ndarray, e: np.ndarray):
    if not len(s):
        return s, e
    o = np.argsort(s)
    s, e = s[o], e[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    starts = s[new]
    ends = np.maximum.reduceat(run_end, np.nonzero(new)[0])
    return starts, ends


def _union(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    ms, me = _merged(s, e)
    return me - ms


def _times(ev):
    """(start, end) in seconds of a kineto event."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


WINDOW = "benchmark.traced_catalogs"


def _annotation(ev) -> bool:
    if ev.name() == WINDOW:
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def reduce_profile(prof, cards: int = 1) -> DeviceTrace:
    """Device and host operations of a finished ``torch.profiler``
    session whose traced catalogs ran inside ``record_function(WINDOW)``,
    which bounds the window on the profiler's own clock; each device
    operation keeps its card's index, for a cell of ``cards`` cards."""
    import torch

    dev_n, dev_s, dev_e, host_n, host_s, host_e = [], [], [], [], [], []
    dev_c = []
    t0 = t1 = None
    for ev in prof.profiler.kineto_results.events():
        s, e = _times(ev)
        if _annotation(ev):
            # record_function ranges, mirrored on the device's timeline
            if ev.name() == WINDOW and \
                    ev.device_type() != torch.autograd.DeviceType.CUDA:
                t0, t1 = s, e
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev_n.append(ev.name())
            dev_s.append(s)
            dev_e.append(e)
            dev_c.append(ev.device_index())
        else:
            host_n.append(ev.name())
            host_s.append(s)
            host_e.append(e)
    if t0 is None:
        raise RuntimeError("the trace holds no traced window")
    return DeviceTrace(dev_n, np.asarray(dev_s), np.asarray(dev_e),
                       host_n, np.asarray(host_s), np.asarray(host_e),
                       t0, t1, np.asarray(dev_c, np.int64), cards)
