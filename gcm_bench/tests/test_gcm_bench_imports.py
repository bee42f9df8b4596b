"""No module that the benchmark runs imports JAX, the JAX package or the
scripts beside it, and the reference imports nothing of the program.
Names compare by their top-level part whole: ``gcm_tpu_torch`` begins with
``gcm_tpu`` and is allowed."""

import ast
import shutil
import subprocess
import sys

from conftest import PACKAGE, ROOT

from gcm_bench.harness.guard import FORBIDDEN, forbidden


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_compare_whole():
    assert forbidden(["gcm_tpu_torch.engine", "gcm_bench.run",
                      "benchmark", "toolsy"]) == []
    assert forbidden(["gcm_tpu.engine", "jax.numpy", "jaxlib", "flax",
                      "bench", "tools.scaling_bench"]) == sorted(FORBIDDEN)


def test_no_source_of_the_benchmark_names_a_forbidden_module():
    for path in PACKAGE.rglob("*.py"):
        assert forbidden(_imports(path)) == [], path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PACKAGE / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"gcm_tpu_torch", "gcm_tpu", "jax"}, path
        assert "gcm_bench.harness" not in set(_imports(path)), path


def test_a_run_holds_no_forbidden_module(small_root):
    """A whole run of a cell on the CPU, in a fresh process that refuses
    every forbidden module and the reference's access to the program."""
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
from gcm_bench.reference import problem, elastic  # the program not loaded
assert not [m for m in sys.modules if m.split('.')[0] == 'gcm_tpu_torch']
from gcm_bench.harness.cell import execute
from gcm_bench.harness.guard import forbidden
from gcm_bench.harness.spec import Spec
spec = Spec({str(small_root)!r})
for cell in ("explosion512", "explosion768-cards4"):
    execute(spec, spec.cell(cell), 3, 0.2, True, "cpu")
loaded = [m for m, v in sys.modules.items() if v is not None]
assert forbidden(loaded) == [], forbidden(loaded)
assert any(m.startswith("gcm_tpu_torch") for m in loaded)
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


def test_a_run_without_the_cards_prints_no_result(tmp_path):
    """Where torch sees fewer cards than the cell asks for (here: none),
    the run exits non-zero with nothing on standard output; so does a
    checkout that holds only the benchmark."""
    cmd = [sys.executable, "-m", "gcm_bench.run", "--workload",
           "explosion512", "--seed", "1", "--seconds", "1", "--trace", "0"]
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(PACKAGE, alone / "gcm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=alone, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
