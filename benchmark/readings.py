"""Readings that set a cell's limits: for each seed, the numbers of one
program catalog (sound runs: the lower readings), of the control
(``reference/control.py``: the upper readings) and of the program with a
fault of ``faults.py`` planted, at the cell's own size, in one process.
The benchmark's runs never run this.

    python benchmark/readings.py --workload <cell> --seeds 11 12 13 \
        [--control-seeds 11 12 13] [--fault unbind_skipped \
        --fault-seeds 11 12 13] > readings.jsonl
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark import faults
    from benchmark.harness import registry
    from benchmark.harness.options import build_options
    from benchmark.harness.runner import _catalog, cell_cards, to_host
    from benchmark.reference import checks, control

    def on_device(host_snap, device):
        snap = copy.copy(host_snap)
        for k in ("pos", "vel", "mass", "ptype"):
            v = getattr(snap, k)
            setattr(snap, k, None if v is None else v.to(device))
        return snap

    if sum(f in faults.PATCHES for f in args.fault) > 1:
        ap.error("one patched fault a process")
    cell = registry.find_cell(args.workload)
    cards = cell_cards(cell.chips, args.device)
    runs = [("program", args.seeds), ("control", args.control_seeds)]
    runs += [(f, args.fault_seeds) for f in args.fault]
    for kind, seeds in runs:
        catalog = _catalog
        if kind in faults.PATCHES:
            # a patch stays for the rest of the process: faults come last
            faults.PATCHES[kind](setattr)
        elif kind in faults.WRAPPERS:
            catalog = faults.WRAPPERS[kind](_catalog)
        for seed in seeds:
            t0 = time.perf_counter()
            snap = cell.generator(cell.config, cell.traffic, seed,
                                  args.device)
            prm = checks.Params(cell.config, snap.boxsize, snap.n, snap.a)
            cards.reset_peaks()
            low = control.lowered(snap) if kind == "control" else None
            # as a run does: the candidate is made with the snapshot on
            # the host alone, the comparison gets it back on the device
            hs = to_host(snap)
            del snap
            cards.empty_cache()
            if low is not None:
                cand = control.build(low, prm)
                del low
            else:
                opt = build_options(cell.config, hs.snap, hs.snap.n)
                cand = catalog(opt, hs, args.device, cards.mesh)
            cards.sync()
            snap = on_device(hs.snap, args.device)
            del hs
            t1 = time.perf_counter()
            catalog_peaks = cards.peaks()
            cards.empty_cache()
            cards.reset_peaks()
            numbers = checks.compare(snap, prm, cand)
            cards.sync()
            t2 = time.perf_counter()
            row = {"workload": args.workload, "kind": kind, "seed": seed,
                   "numbers": numbers, "catalog_s": t1 - t0,
                   "compare_s": t2 - t1}
            if catalog_peaks:
                # card 0's peaks in GiB: the candidate's making (the
                # control's with its lowered snapshot), and the comparison
                row["catalog_peak_gib"] = catalog_peaks[0] / 2 ** 30
                row["compare_peak_gib"] = cards.peaks()[0] / 2 ** 30
            if snap.sub_sizes is not None and len(snap.sub_sizes):
                # each planted subhalo's size and the most of it that one
                # substructure holds
                held = checks.subhalo_held(
                    torch.as_tensor(np.asarray(cand.pfof, np.int64),
                                    device=snap.sub_of.device),
                    cand.parent, snap.sub_of, len(snap.sub_sizes))
                row["subhalos"] = [[int(a), int(b)] for a, b in
                                   zip(snap.sub_sizes, held)]
            print(json.dumps(row), flush=True)
            del snap, cand
            cards.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
