"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``bialign_tpu_torch`` begins with ``bialign_tpu``),
and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bialign_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_not_the_program(path):
    assert "bialign_tpu_torch" not in set(_imports(path))
    assert "portbench" not in set(_imports(path))   # relative imports only


def test_loaded_modules_after_a_run():
    """A run's process, the harness and the program included, loads no
    module of JAX or of the JAX package (a subprocess, so this test's own
    imports do not count)."""
    code = (
        "import sys, time\n"
        "from portbench.tests.tiny import tiny_cell, run_tiny\n"
        "from pathlib import Path\n"
        "import tempfile\n"
        "cell = tiny_cell(Path(tempfile.mkdtemp()), 'readme-dnapol1.pair')\n"
        "assert run_tiny(cell, seconds=0.2)['correct']\n"
        "from portbench import harness\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
