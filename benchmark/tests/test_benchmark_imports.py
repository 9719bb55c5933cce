"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the
program."""

import ast
import sys
from pathlib import Path

from benchmark.harness import runner

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "velociraptor_stf_tpu"}
PROGRAM = "velociraptor_stf_tpu_torch"


def imported_tops(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        text = f.read_text()
        assert PROGRAM not in imported_tops(f), f
        assert PROGRAM not in text, f


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PROGRAM + ".probe", object())
    assert "velociraptor_stf_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "velociraptor_stf_tpu.probe", object())
    assert "velociraptor_stf_tpu" in runner.forbidden_modules()
