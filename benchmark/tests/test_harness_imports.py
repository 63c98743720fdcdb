"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names compared
whole, so the port's name, which begins with the JAX package's, is not
mistaken for it."""

import ast
import subprocess
import sys

from harness_small import BENCH
from mcbench import core

JAX = {"jax", "jaxlib", "flax", "montecarlo_tpu"}
PORT = "montecarlo_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_under_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        found = set(_imports(f)) & JAX
        assert not found, (f, found)


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "mcref").glob("*.py")):
        tops = set(_imports(f))
        assert PORT not in tops and not tops & JAX, (f, tops)
        assert tops <= {"__future__", "torch", "numpy", "mcref", "math"}, \
            (f, tops)


def test_reference_loads_no_port_module():
    code = ("import sys; sys.path[:0] = [%r]; import mcref.cards, "
            "mcref.equity, mcref.table; print(sorted({m.split('.')[0] for m "
            "in sys.modules} & {%r, 'jax', 'montecarlo_tpu'}))"
            % (str(BENCH), PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "montecarlo_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "montecarlo_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "montecarlo_tpu", sys)
    monkeypatch.setitem(sys.modules, "montecarlo_tpu.ops", sys)
    assert core.forbidden_modules() == ["montecarlo_tpu",
                                        "montecarlo_tpu.ops"]
