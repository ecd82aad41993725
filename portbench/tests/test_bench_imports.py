"""Nothing under portbench/ imports JAX, flax, optax or the JAX package
(top-level names compared whole, so the port's own name passes), nothing
it runs reads the JAX benchmark's folder, and the references import
nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fgnn_tpu", "bench",
             "benchmarks"}


def modules(path):
    """Top-level names of every import in a Python file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def sources(sub=""):
    for root, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    bad = set(modules(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "fgnn_tpu_torch" not in set(modules(path))


def test_the_scan_sees_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import fgnn_tpu_torch.models\nimport jax.numpy\n"
                     "from flax import x\n")
    assert set(modules(str(probe))) == {"fgnn_tpu_torch", "jax", "flax"}
    assert not set(modules(str(probe))) & {"fgnn_tpu"}
