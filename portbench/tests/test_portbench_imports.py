"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent


def imported_top_levels(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_top_levels(f) & set(harness.FORBIDDEN), f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert imported_top_levels(f) <= {"__future__", "contextlib", "importlib", "math",
                                          "typing", "dataclasses", "torch"}, f
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.models, "
            "portbench.reference.counts, "
            "portbench.reference.fno, portbench.reference.unet, "
            "portbench.reference.weights, portbench.reference.precision; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cfdbench_tpu_torch', 'cfdbench_tpu', 'jax', 'flax', 'jaxlib')))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    allowed = {"cfdbench_tpu_torch", "cfdbench_tpu_torch.ops", "jaxtyping", "flaxen"}
    for name in allowed:
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_modules()) & allowed
    monkeypatch.setitem(sys.modules, "cfdbench_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"cfdbench_tpu.models", "jaxlib"} <= set(harness.forbidden_modules())
