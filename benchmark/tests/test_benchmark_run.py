"""Whole runs of each cell on the CPU at a small size (the harness's
look for a card skipped): the last line's shape and ``correct``; and the
command's refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.harness import runner
from benchmark.tests.tiny import REPO, tiny_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", ["dmcosmo.z6", "swifthydro6d.z6"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_its_result_line(root, cell, trace, capsys):
    rc = runner.run(cell, 2 ** 31 + 99, 1.0, bool(trace),
                    time.perf_counter(), root=root, device="cpu")
    assert rc == 0
    res = last_line(capsys)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    want = [m["name"] for m in manifest["per_layer" if trace else
                                        "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]
    got = list(res["metrics"])
    if trace:
        # no device trace on the CPU, and at this size the hydro cell's
        # hosts are too small for merger cores: those readers stay silent
        silent = ("kernels.", "device.", "substructure.cores_s")
        want = [w for w in want if not w.startswith(silent)]
        got = [g for g in got if not g.startswith(silent)]
        assert "breakdown" in res and {"busy_s", "window_s"} <= \
            set(res["device"])
    assert got == want
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def test_without_a_card_the_command_prints_no_result(tmp_path):
    """The command exits non-zero and prints no result without CUDA, and
    in a directory that holds only BENCHMARK.json and benchmark/."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for where in (REPO, tmp_path):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "dmcosmo.z6", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=where, capture_output=True, text=True, env=env,
            timeout=300)
        assert p.returncode != 0
        assert p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_run_on_the_card(card, capsys):
    """One short run of the hydro cell on the card, at its full size."""
    rc = runner.run("swifthydro6d.z6", 2 ** 31 + 5, 2.0, False,
                    time.perf_counter())
    assert rc == 0
    res = last_line(capsys)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
