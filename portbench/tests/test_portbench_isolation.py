"""What the benchmark runs on the card imports neither JAX nor the JAX
package, and the reference imports nothing of the program. Names are
compared by their top-level part whole: ``omnia_tpu_torch`` is the
program, ``omnia_tpu`` the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "omnia_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def chip_sources():
    return [p for p in PB.rglob("*.py") if "tests" not in p.relative_to(PB).parts]


def test_the_whole_name_is_compared(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import omnia_tpu_torch.models\nfrom omnia_tpu.ops import x\nimport jaxlib\n")
    assert top_level_imports(probe) & FORBIDDEN == {"omnia_tpu", "jaxlib"}


@pytest.mark.parametrize("path", chip_sources(), ids=lambda p: str(p.relative_to(PB)))
def test_nothing_on_the_card_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_a_run_leaves_no_jax_module_loaded():
    """The run's own check, in a fresh process: a tiny cell on the CPU,
    then the modules that process holds."""
    code = ("import sys; from pathlib import Path; import tempfile\n"
            "from portbench import run, spec\nfrom portbench.tests import tiny\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    root = tiny.make_root(Path(d))\n"
            "    cell = spec.load_cell(root, 'tiny.open')\n"
            "    res = run.run_cell(cell, 'tiny.open', 9, 2.0, False, 'cpu', root=root)\n"
            "print(res['correct'], run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_the_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mistral7b.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=PB.parent, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
