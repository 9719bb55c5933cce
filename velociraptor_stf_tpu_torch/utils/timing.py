"""Phase timing / logging.

The port's copy of ``velociraptor_stf_tpu/utils/timing.py``, kept so that
the port imports nothing of the JAX package.

Equivalent of the reference's wall-clock instrumentation
(``MyGetTime`` reference utilities.cxx:36 and the ``TIME::`` phase
lines printed by main.cxx:247-534).  ``profile_trace`` is the JAX
package's profiler context on ``torch.profiler`` (a Chrome trace in place
of a jax.profiler trace).  ``device_clock`` is the port's stage clock: it
reads the host time after the card has finished its work.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional


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


def device_clock(device) -> Callable[[], float]:
    """A stage clock: host seconds, read after ``device`` (a
    ``torch.device``) has finished every queued kernel."""
    def clock() -> float:
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        return time.perf_counter()
    return clock


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
