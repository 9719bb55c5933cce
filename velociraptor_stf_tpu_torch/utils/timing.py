"""Phase timing, spans and the profiler trace.

Once the port's copy of ``velociraptor_stf_tpu/utils/timing.py``, kept so
that the port imports nothing of the JAX package.

``PhaseTimer`` is the reference's wall-clock instrumentation (``MyGetTime``
reference utilities.cxx:36 and the ``TIME::`` phase lines printed by
main.cxx:247-534).  ``profile_trace`` is the JAX package's profiler
context on ``torch.profiler`` (a Chrome trace in place of a jax.profiler
trace).

``span`` marks a piece of the pipeline's work, in two tiers:

- a *stage span* is given a ``timings`` dict and adds its seconds to
  ``timings[key]``, read on the host after ``device`` has finished its
  queued work at both ends (the stage times of ``find_structures``);
- a *fine span* has no ``timings``: it never synchronises, and costs one
  flag check while nothing records.

Spans record while a ``torch.profiler`` session is active, and only then.
Each open span is then a host range of the profiler named by the span and
its attributes (the Chrome trace shows the tree; the card's timeline
holds no copy of it), and each closed one leaves a record in
a bounded buffer (``spans()``, ``clear_spans()``): its ``id``, its
``parent``'s, its ``catalog`` (the id of the outermost open span, shared
by every span of one catalog), ``name``, ``t0_ns`` / ``t1_ns`` on the
profiler's host clock (``time.time_ns``) and ``attrs``.  ``utils/
telemetry.count`` adds to the innermost open span's ``attrs["counts"]``
meanwhile, so its counters can be read per catalog and per stage.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from pathlib import Path
from typing import Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# records the buffer holds; the oldest go first beyond it
MAX_SPANS = 1 << 16

_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_OPEN: List[dict] = []          # the open spans that record, outermost first
_IDS = itertools.count(1)
_dropped = 0


class PhaseTimer:
    """Collects per-phase wall-clock times; prints reference-style TIME::
    lines when verbose."""

    def __init__(self, verbose: int = 0):
        self.verbose = verbose
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.record(name, time.time() - t0)

    def record(self, name: str, dt: float):
        self.times[name] = self.times.get(name, 0.0) + dt
        if self.verbose:
            print(f"TIME::{name} took {dt:.6g} s")

    def report(self):
        total = sum(self.times.values())
        if self.verbose:
            for k, v in self.times.items():
                print(f"TIME::{k} {v:.6g} s")
        print(f"TIME::total {total:.6g} s "
              f"({', '.join(f'{k}={v:.3g}' for k, v in self.times.items())})")


def recording() -> bool:
    """Whether spans record: a ``torch.profiler`` session is active."""
    return _profiler._is_profiler_enabled


class _Span:
    def __init__(self, name: str, timings, key, device, attrs):
        self.name, self.timings, self.key = name, timings, key or name
        self.device, self.attrs = device, attrs
        self.rec = self.range = None

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        if self.timings is not None:
            _sync(self.device)
        if recording():
            # a host range: a ``record_function`` range would be mirrored
            # onto the card's timeline, where it reads as device work
            label = ", ".join(f"{k}={v}" for k, v in self.attrs.items())
            self.range = _RecordFunctionFast(
                f"{self.name} ({label})" if label else self.name)
            self.range.__enter__()
            sid = next(_IDS)
            self.rec = {"id": sid,
                        "parent": _OPEN[-1]["id"] if _OPEN else None,
                        "catalog": _OPEN[0]["id"] if _OPEN else sid,
                        "name": self.name, "attrs": self.attrs}
            _OPEN.append(self.rec)
            self.rec["t0_ns"] = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        # a stage that raised adds no time, as a stage clock never read
        if self.timings is not None and kind is None:
            _sync(self.device)
            self.timings[self.key] = self.timings.get(self.key, 0.0) + \
                time.perf_counter() - self.t0
        if self.rec is not None:
            self.rec["t1_ns"] = time.time_ns()
            _OPEN.remove(self.rec)
            _keep(self.rec)
            self.range.__exit__(kind, value, tb)
        return False


class _Off:
    """A fine span while nothing records."""

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False


_OFF = _Off()


def span(name: str, timings: Optional[Dict[str, float]] = None,
         key: Optional[str] = None, device=None, **attrs):
    """A span of the work in the ``with`` block (see the module's
    docstring).  With ``timings``, a stage span: its seconds are added to
    ``timings[key or name]``, synchronising ``device`` (a
    ``torch.device``; a CUDA one is waited for) at both ends."""
    if timings is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, timings, key, device, attrs)


def add_count(key: str, n: int) -> None:
    """Add ``n`` to the innermost open span's ``attrs["counts"][key]``."""
    if _OPEN:
        counts = _OPEN[-1]["attrs"].setdefault("counts", {})
        counts[key] = counts.get(key, 0) + n


def spans() -> List[dict]:
    """The closed spans recorded, oldest first by end."""
    return list(_SPANS)


def dropped_spans() -> int:
    """Records dropped since the last ``clear_spans`` (the buffer full)."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    _SPANS.clear()
    _dropped = 0


def _keep(rec: dict) -> None:
    global _dropped
    if len(_SPANS) == _SPANS.maxlen:
        _dropped += 1
    _SPANS.append(rec)


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (the host, and the card
    when one is present), written as Chrome trace JSON to ``logdir``
    (created when missing; the CLI's ``VR_PROFILE=<dir>``); a no-op when
    ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{int(time.time() * 1e3)}"
                                         ".json"))
