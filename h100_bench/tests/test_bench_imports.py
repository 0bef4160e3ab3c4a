"""No module of the benchmark imports JAX or the JAX package; the
reference imports nothing of the program."""

import ast
import subprocess
import sys

from h100_bench import run, spec

JAX_NAMES = {"jax", "jaxlib", "flax", "icepy4d_tpu"}


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["icepy4d_tpu_torch", "icepy4d_tpu_torch.ops",
                                  "numpy", "jaxtyping", "jax_like"]) == []
    assert run.forbidden_modules(["jax.numpy", "icepy4d_tpu.ops",
                                  "flax.linen", "torch"]) == \
        ["flax", "icepy4d_tpu", "jax"]


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    for path in spec.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not (_imports(path) & JAX_NAMES), path


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert "icepy4d_tpu_torch" not in _imports(path), path
    code = ("import sys, h100_bench.reference.check, "
            "h100_bench.reference.superglue, h100_bench.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'icepy4d_tpu_torch', 'icepy4d_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = ("import sys, h100_bench.run, h100_bench.control; "
            "from h100_bench import spec; "
            "spec.module('loops', 'pair_match'); "
            "import icepy4d_tpu_torch.matching; "
            "print(h100_bench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
