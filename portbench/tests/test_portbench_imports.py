"""What the benchmark loads: no module of JAX or of the JAX package (their
top-level names compared whole, so ``jpegtpu_torch`` is not
``jpegtpu``), and a reference that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "jpegtpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not (
                node.level):
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "jpegtpu_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "functools", "struct", "numpy",
                              "torch", "portbench"}


def test_a_run_loads_no_jax():
    """Import every module of the harness, load every metric reader and
    run a cell at a tiny size on the CPU, in a fresh process; then no
    loaded module may be JAX's or the JAX package's."""
    code = """
import sys, json, torch
from portbench import harness, bounds, control, frames, timeline
from portbench.reference import jpeg, tables
import portbench.run
bench = harness.Bench()
for key in ("end_to_end", "per_layer"):
    for m in bench.spec[key]:
        bench.reader(m["name"])
result, _ = harness.run_cell(
    bench, "uhd_420_q90.device_ring", 1, 0.1, False, torch.device("cpu"),
    0.0, {"width": 32, "height": 16, "canvas": [16, 32]})
assert result["correct"]
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in %r)))
""" % sorted(FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
