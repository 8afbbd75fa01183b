"""The benchmark imports neither JAX nor the JAX package, and its
reference imports nothing of the program either."""

import ast
import pathlib

from benchmark.core import harness

BENCH = pathlib.Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "pointgnn_tpu"}


def imported_tops(path):
    """Top-level names of every module ``path`` imports (whole names:
    ``pointgnn_tpu_torch.x`` -> ``pointgnn_tpu_torch``)."""
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p): sorted(imported_tops(p) & JAX_SIDE) for p in sources()
           if imported_tops(p) & JAX_SIDE}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    assert sources("reference")
    bad = {str(p): sorted(imported_tops(p)) for p in sources("reference")
           if "pointgnn_tpu_torch" in imported_tops(p)
           or imported_tops(p) & JAX_SIDE}
    assert not bad


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["pointgnn_tpu_torch",
                                      "pointgnn_tpu_torch.infer",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["pointgnn_tpu.infer", "jax._src",
                                      "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax._src", "jaxlib", "pointgnn_tpu.infer"]


def test_imported_tops_sees_each_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom pointgnn_tpu import x\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n"
                 "from . import sibling\nimport pointgnn_tpu_torch\n")
    assert imported_tops(f) == {"jax", "pointgnn_tpu", "importlib", "flax",
                                "pointgnn_tpu_torch"}
