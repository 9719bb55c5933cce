"""Where the spread of a cell's catalog times comes from: catalogs of one
seed timed back to back, each followed by two probes of the host, and a
device trace of further catalogs broken down one catalog at a time.
The benchmark's runs never run this.

    python benchmark/spread.py --workload <cell> --seed <n> \
        [--catalogs 40] [--traced 12] > spread.jsonl

Per timed catalog: its wall, the sum of its stage times, the seconds of
a fixed host task (``cpu_probe_s``: numpy and Python work, no device),
and of a pageable copy of the positions to the card (``h2d_probe_s``).
Per traced catalog: wall, the union of device operations (busy), the
host-to-device and device-to-host copies, and the host's seconds inside
CUDA calls that wait for the card (synchronise, copy), with their count
and the count of kernel launches.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaMemcpyAsync", "cudaEventSynchronize")


def cpu_probe() -> float:
    import numpy as np

    t0 = time.perf_counter()
    x = np.arange(1 << 20, dtype=np.float64)
    for _ in range(20):
        x = np.sqrt(x * 1.0001 + 1.0)
    s = 0
    for i in range(200000):
        s += i & 7
    return time.perf_counter() - t0


def h2d_probe(pos) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.from_numpy(pos).to("cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def per_catalog(prof, n: int):
    """Each traced catalog's breakdown, from the profiler's events."""
    import numpy as np
    import torch

    from benchmark.harness.trace import _times, _union

    def annotation(ev) -> bool:
        kind = getattr(ev, "activity_type", None)
        return kind is not None and "annotation" in str(kind()).lower()

    spans, dev, host = {}, [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = _times(ev)
        name = ev.name()
        on_dev = ev.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith("spread.catalog") or annotation(ev):
            # record_function ranges, mirrored on the device's timeline
            if name.startswith("spread.catalog") and not on_dev:
                spans[int(name.rsplit(".", 1)[1])] = (s, e)
        elif on_dev:
            dev.append((name, s, e))
        elif name.startswith("cuda"):
            host.append((name, s, e))
    out = []
    for i in range(n):
        t0, t1 = spans[i]
        d = [(nm, max(s, t0), min(e, t1)) for nm, s, e in dev
             if e > t0 and s < t1]
        h = [(nm, s, e) for nm, s, e in host if s >= t0 and e <= t1]
        st = np.array([x[1] for x in d])
        en = np.array([x[2] for x in d])
        waits = [e - s for nm, s, e in h if nm in WAITS]
        out.append({
            "catalog": i, "wall_s": t1 - t0,
            "busy_s": float(_union(st, en).sum()) if len(d) else 0.0,
            "h2d_s": sum(e - s for nm, s, e in d if "HtoD" in nm),
            "d2h_s": sum(e - s for nm, s, e in d if "DtoH" in nm),
            "host_wait_s": float(sum(waits)), "waits": len(waits),
            "launches": sum(nm == "cudaLaunchKernel" for nm, _, _ in h)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--catalogs", type=int, default=40)
    ap.add_argument("--traced", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import registry
    from benchmark.harness.options import build_options
    from benchmark.harness.runner import (_catalog, cell_cards, power_limit,
                                          to_host)

    cell = registry.find_cell(args.workload)
    cards = cell_cards(cell.chips, "cuda")
    snap = cell.generator(cell.config, cell.traffic, args.seed, "cuda")
    opt = build_options(cell.config, snap, snap.n)
    hs = to_host(snap)
    del snap
    cards.empty_cache()
    _catalog(opt, hs, "cuda", cards.mesh)
    cards.sync()
    head = {"workload": args.workload, "seed": args.seed,
            "card": power_limit()}
    for i in range(args.catalogs):
        c0 = time.perf_counter()
        res = _catalog(opt, hs, "cuda", cards.mesh)
        cards.sync()
        wall = time.perf_counter() - c0
        print(json.dumps(dict(head, kind="timed", catalog=i, wall_s=wall,
                              stages_s=sum(v for k, v in res.timings.items()
                                           if "_" not in k),
                              timings=res.timings, cpu_probe_s=cpu_probe(),
                              h2d_probe_s=h2d_probe(hs.arrays["pos"]))),
              flush=True)
        del res
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.traced):
            with record_function(f"spread.catalog.{i}"):
                _catalog(opt, hs, "cuda", cards.mesh)
                cards.sync()
    for row in per_catalog(prof, args.traced):
        print(json.dumps(dict(head, kind="traced", **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
