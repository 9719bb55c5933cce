"""Where a cell's host waits, launches and idle time fall: the program's
spans of traced catalogs, each with the host calls that wait for the
card, the kernel launches and the card's idle share inside it, per
catalog.  The benchmark's runs never run this.

    python benchmark/stages.py --workload <cell> --seed <n> > stages.jsonl

One line per span name: spans a catalog, seconds a catalog (traced),
waits and launches a catalog, idle share (%).  Spans of one name never
overlap, so their counts add up; a span's counts include its children's.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def breakdown(workload: str, seed: int, device: str = "cuda", root=None):
    """Rows of the traced catalogs of one run of ``workload``, one a span
    name, in the order the spans close in the first catalog."""
    import torch

    from benchmark.harness import registry, runner, spans
    from benchmark.harness.options import build_options
    from velociraptor_stf_tpu_torch.utils import timing

    cell = registry.find_cell(workload, root)
    snap = cell.generator(cell.config, cell.traffic, seed, device)
    opt = build_options(cell.config, snap, snap.n)
    hs = runner.to_host(snap)
    del snap
    cards = runner.cell_cards(cell.chips, device)
    runner._catalog(opt, hs, device, cards.mesh)
    cards.sync()
    timing.clear_spans()
    trace, _ = runner._traced(opt, hs, cards, runner._catalog)
    cats = spans.traced(runner.Ctx(runner.Window(), trace, None))
    if cats is None:
        raise SystemExit("the program recorded no spans")
    names = list(dict.fromkeys(r["name"] for r in cats.records))
    rows = []
    for name in names:
        s, e = cats.intervals(name)
        rows.append({"workload": workload, "seed": seed, "span": name,
                     "catalogs": cats.n, "spans": cats.count(name),
                     "seconds": float((e - s).sum()) / cats.n,
                     "waits": cats.host_calls(name, "waits"),
                     "launches": cats.host_calls(name, "launches"),
                     "idle_share": cats.idle_share(name)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for row in breakdown(args.workload, args.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
