"""One run of one cell: set-up, warm-up, the measured window, the
optional traced catalogs, then the comparison that decides ``correct``
and the result line.

The window drives one entry, ``models/pipeline.py::find_structures``,
with the snapshot as host numpy arrays (as the CLI hands it a snapshot
it has read), so each catalog's transfer in and copies out are inside
it.  A catalog starts while less than ``seconds`` have passed since the
window opened, and the last one finishes on every card of the cell; the
window ends with it.

A cell of ``chips`` N > 1 runs every catalog over a mesh of its N cards
(``parallel/mesh.py::make_mesh``; N shards on the CPU), and its memory,
syncs and trace take every card; a cell of one card calls
``find_structures`` with no mesh.
"""

from __future__ import annotations

import copy
import json
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from . import e2e, registry

FORBIDDEN = ("jax", "jaxlib", "flax", "velociraptor_stf_tpu")
# seconds of catalogs the traced run profiles (at least one catalog)
PROFILE_S = 3.0


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not
    load, compared whole (``velociraptor_stf_tpu_torch`` is the port)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class HostSnapshot:
    """The snapshot on the host: numpy arrays for the program, torch
    tensors for the reference."""
    snap: object
    arrays: Dict[str, object]


def to_host(snap) -> HostSnapshot:
    """Copy the generated snapshot to the host once."""
    host = copy.copy(snap)
    for k in ("pos", "vel", "mass", "ptype", "sub_of"):
        v = getattr(snap, k)
        setattr(host, k, None if v is None else v.cpu())
    host.extras = {k: v.cpu() for k, v in snap.extras.items()}
    arrays = dict(pos=host.pos.numpy(), vel=host.vel.numpy(),
                  mass=host.mass.numpy(),
                  ptype=None if host.ptype is None else host.ptype.numpy(),
                  extras={k: v.numpy() for k, v in host.extras.items()}
                  or None)
    return HostSnapshot(host, arrays)


@dataclass
class Window:
    walls: List[float] = field(default_factory=list)
    timings: List[Dict[str, float]] = field(default_factory=list)
    seconds: float = 0.0
    sample: object = None
    sample_index: int = -1


class Ctx:
    """What a per-layer metric reads: the window's catalogs, the traced
    catalogs' device trace, and the FOF kernels' work."""

    def __init__(self, window: Window, trace, fof_work: Callable):
        self.window = window
        self.trace = trace
        self._fof_work = fof_work
        self._work = None
        self.outside = e2e.outside_s

    def mean_over_catalogs(self, fn) -> Optional[float]:
        vals = [fn(w, t) for w, t in zip(self.window.walls,
                                         self.window.timings)]
        return e2e.mean(vals) if vals else None

    def stage_mean(self, key: str) -> Optional[float]:
        if not any(key in t for t in self.window.timings):
            return None
        return e2e.mean([t.get(key, 0.0) for t in self.window.timings])

    def fof_work(self):
        if self._work is None:
            self._work = self._fof_work()
        return self._work


def _catalog(opt, hs: HostSnapshot, device: str, mesh=None):
    """One catalog of the snapshot; over ``mesh`` where the cell has
    several cards, else with no mesh argument."""
    from velociraptor_stf_tpu_torch.models.pipeline import find_structures

    a = hs.arrays
    kw = {} if mesh is None else {"mesh": mesh}
    return find_structures(copy.deepcopy(opt), a["pos"], a["vel"],
                           a["mass"], boxsize=hs.snap.boxsize,
                           ptype=a["ptype"], extras=a["extras"],
                           device=device, **kw)


@dataclass(frozen=True)
class Cards:
    """Where a cell runs: the device kind, the mesh over its cards (None
    for one card) and the CUDA cards it syncs, frees and reads (none on
    the CPU)."""
    device: str
    mesh: object = None
    ids: Tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def sync(self):
        import torch

        for i in self.ids:
            torch.cuda.synchronize(i)

    def empty_cache(self):
        import torch

        for i in self.ids:
            with torch.cuda.device(i):
                torch.cuda.empty_cache()

    def reset_peaks(self):
        import torch

        for i in self.ids:
            torch.cuda.reset_peak_memory_stats(i)

    def peaks(self) -> List[int]:
        """Each card's ``max_memory_allocated`` since its last reset."""
        import torch

        return [int(torch.cuda.max_memory_allocated(i)) for i in self.ids]

    def names(self) -> List[str]:
        import torch

        return [torch.cuda.get_device_name(i) for i in self.ids]


def cell_cards(chips: int, device: str) -> Cards:
    """The cards of a cell of ``chips``: cards 0..chips-1 with a mesh over
    them where there are several (``chips`` CPU shards on the CPU)."""
    mesh = None
    if chips > 1:
        from velociraptor_stf_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(chips, device)
    ids = tuple(range(chips)) if device == "cuda" else ()
    return Cards(device, mesh, ids)


def run_window(opt, hs: HostSnapshot, seconds: float, cards: Cards,
               rng: random.Random, catalog=_catalog) -> Window:
    """Whole catalogs back to back for ``seconds``; keeps one catalog,
    drawn uniformly from the seed, for the comparison."""
    win = Window()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        c0 = time.perf_counter()
        res = catalog(opt, hs, cards.device, cards.mesh)
        cards.sync()
        c1 = time.perf_counter()
        win.walls.append(c1 - c0)
        win.timings.append(dict(res.timings))
        k = len(win.walls)
        if rng.random() * k < 1.0:
            win.sample, win.sample_index = res, k - 1
        del res
    win.seconds = time.perf_counter() - t0
    return win


def power_limit() -> str:
    """Every card's name and power limit, one card after another."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return "; ".join(out.stdout.strip().splitlines()) or "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, root: Optional[Path] = None, device: str = "cuda",
        catalog=_catalog) -> int:
    """One run; prints the result line and returns the exit code."""
    import torch

    cell = registry.find_cell(workload, root)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"{workload} needs {cell.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        torch.cuda.init()
        from velociraptor_stf_tpu_torch.kernels import _build

        _build.load_library()
    cards = cell_cards(cell.chips, device)
    from benchmark.harness.options import build_options
    from benchmark.reference import checks

    # the snapshot, made on the device from the seed, copied to the
    # host once; the device copy is freed before the window
    snap = cell.generator(cell.config, cell.traffic, seed, device)
    opt = build_options(cell.config, snap, snap.n)
    hs = to_host(snap)
    del snap
    cards.empty_cache()

    warm = catalog(opt, hs, device, cards.mesh)
    cards.sync()
    del warm
    setup_s = time.perf_counter() - t_start

    cards.reset_peaks()
    rng = random.Random(seed * 1000003 + 17)
    win = run_window(opt, hs, seconds, cards, rng, catalog)
    # the fullest card's peak
    peaks = cards.peaks() or [0] * cell.chips
    peak = max(peaks)
    for w, t in zip(win.walls, win.timings):
        log(f"catalog {w:.4f} s: " + " ".join(
            f"{k} {v:.4f}" for k, v in t.items()))
    log(f"window: {len(win.walls)} catalogs in {win.seconds:.3f} s; "
        f"walls {min(win.walls):.4f}-{max(win.walls):.4f} s; "
        f"sample #{win.sample_index}; setup {setup_s:.3f} s; "
        f"peak {peak / 2**30:.3f} GiB; per card " +
        " ".join(f"{p / 2**30:.3f}" for p in peaks))

    dtrace = None
    if trace:
        t0 = time.perf_counter()
        dtrace, traced = _traced(opt, hs, cards, catalog)
        log(f"tracing took {time.perf_counter() - t0:.3f} s, "
            f"{len(dtrace.names)} device and {len(dtrace.host_names)} "
            f"host operations")
        over = e2e.mean(traced) / e2e.mean(win.walls) - 1.0
        log(f"traced {len(traced)} catalogs: mean wall "
            f"{e2e.mean(traced):.4f} s against {e2e.mean(win.walls):.4f} "
            f"s untraced ({100 * over:+.2f}% trace overhead)")

    found = forbidden_modules()
    if found:
        log("modules the benchmark may not load: " + ", ".join(found))
        return 3

    # the comparison, on the device once the program's state is freed
    cards.empty_cache()
    ref_snap = copy.copy(hs.snap)
    for k in ("pos", "vel", "mass", "ptype"):
        v = getattr(ref_snap, k)
        setattr(ref_snap, k, None if v is None else v.to(device))
    t0 = time.perf_counter()
    prm = checks.Params(cell.config, hs.snap.boxsize, hs.snap.n, hs.snap.a)
    try:
        numbers = checks.compare(ref_snap, prm, win.sample, device=device)
    except ValueError as err:       # a catalog of the wrong shape
        log(f"the catalog cannot be compared: {err}")
        numbers = {}
    log(f"comparison took {time.perf_counter() - t0:.3f} s")
    verdict = {k: {"value": numbers.get(k), "limit": lim}
               for k, lim in cell.limits.items()}
    correct = all(k in numbers and numbers[k] <= lim
                  for k, lim in cell.limits.items())

    t0 = time.perf_counter()
    if trace:
        def fof_work():
            from benchmark.roofline import fof

            pos = ref_snap.pos
            if ref_snap.ptype is not None and prm.baryons:
                pos = pos[ref_snap.ptype == 1]
            return fof.count(pos, prm.b3d, prm.box)

        ctx = Ctx(win, dtrace, fof_work)
        metrics = {}
        for m in cell.per_layer:
            v = registry.metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {
            "catalog_rate": e2e.catalog_rate(hs.snap.n, len(win.walls),
                                             win.seconds),
            "catalog_s_p95": e2e.nearest_rank(win.walls, 95.0),
            "peak_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    log(f"metrics took {time.perf_counter() - t0:.3f} s")
    kinds = cards.names() or [device] * cell.chips
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": kinds[0], "count": cell.chips,
           "memory_peak_bytes": int(peak),
           "memory_peak_bytes_per_card": peaks, "kinds": kinds}
    out = {"correct": bool(correct), "attempted": len(win.walls),
           "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["busy_s_per_card"] = dtrace.busy_per_card()
        dev["window_s"] = dtrace.window_s()
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           dtrace.top_ops(10)],
                            "idle_gaps": [list(x) for x in
                                          dtrace.idle_gaps(10)]}
    out["checks"] = verdict
    log(f"cards: {power_limit() if device == 'cuda' else device}")
    log(f"numbers not held to a limit: " + json.dumps(
        {k: v for k, v in numbers.items() if k not in cell.limits}))
    for k, v in verdict.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


def _traced(opt, hs: HostSnapshot, cards: Cards, catalog):
    """Profile whole catalogs for at least PROFILE_S seconds (one at
    least), events kept in memory, each device operation with its
    card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import WINDOW, reduce_profile

    acts = [ProfilerActivity.CPU]
    if cards.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    walls = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            while not walls or time.perf_counter() - t0 < PROFILE_S:
                c0 = time.perf_counter()
                res = catalog(opt, hs, cards.device, cards.mesh)
                cards.sync()
                walls.append(time.perf_counter() - c0)
                del res
    return reduce_profile(prof, cards.count), walls
