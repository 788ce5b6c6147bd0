"""The import rule, by top-level module name compared whole: no file of the
benchmark imports JAX, Flax, optax or the JAX package, the reference
imports nothing of the program, and nothing loads them at run time."""

import ast
import os
import subprocess
import sys

from benchmark.harness import FORBIDDEN_MODULES
from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN_MODULES), (path, tops & set(FORBIDDEN_MODULES))


def test_reference_imports_nothing_of_the_program():
    """The reference's files import only the standard library, torch and the
    benchmark's own reference and weights, which import nothing else."""
    allowed = {"benchmark.weights", "benchmark.reference.envs", "benchmark.reference.dqn", "__future__", "torch",
               "torch.nn.functional", "math", "contextlib"}
    for path in [*(BENCH / "reference").glob("*.py"), BENCH / "weights.py"]:
        names = set(_imports(path))
        assert names <= allowed, (path, names - allowed)
        assert "tianshou_tpu_torch" not in {n.split(".")[0] for n in names}


def test_top_level_names_compared_whole():
    from benchmark.harness import forbidden_loaded

    assert forbidden_loaded(["tianshou_tpu_torch", "tianshou_tpu_torch.algos.dqn", "numpy", "jaxtyping"]) == []
    assert forbidden_loaded(["tianshou_tpu.algos", "jaxlib.xla_client", "flax", "optax.tree"]) == [
        "flax", "jaxlib", "optax", "tianshou_tpu"]


def test_nothing_loads_jax_at_run_time():
    code = ("import sys; import benchmark.harness, benchmark.reference.dqn, benchmark.calibrate; "
            "import benchmark.builders.dqn_device; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'optax', 'tianshou_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    code = "import sys; import benchmark.reference.dqn; print('tianshou_tpu_torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
