"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, metrics and limits are found
by name from ``BENCHMARK.json`` at the checkout's root (see
``benchmark/README.md``).  Exits non-zero, printing no result, without
enough CUDA devices for the cell.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner

    return runner.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
