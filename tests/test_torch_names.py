"""The port is complete: every public name of the JAX package has its
counterpart in ``fgnn_tpu_torch``.

An AST scan, no imports.  Every public top-level name (a def, a class or
an assignment, no leading ``_``) of each ``fgnn_tpu/**.py`` must be
defined or imported by the same name in the same path under
``fgnn_tpu_torch/``, or stand in ``COUNTERPARTS`` with the port name that
does its work, which must resolve by AST.  Every name of a JAX
subpackage's ``__all__`` must be in the port subpackage's ``__all__`` or
in the map.  ``__graft_entry__.py``'s entry points are
``fgnn_tpu_torch/entry.py``'s.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX name -> (port name that does its work, why the names differ)
COUNTERPARTS = {
    "ops.fused_mp.fused_typed_mp": (
        "ops.fused_mp.typed_gather_mix_agg",
        "the kernels' wrapper (its autograd node: TypedGatherMixAgg)"),
    "ops.fused_mp.fused_supported": (
        "ops.fused_mp.check_kernel_args",
        "the port raises where the kernel does not fit: no XLA fallback"),
    "parallel.mesh.set_spmd_mesh": (
        "parallel.mesh.Mesh", "the mesh is passed explicitly: no registry"),
    "parallel.mesh.spmd_mesh": (
        "parallel.mesh.Mesh", "the mesh is passed explicitly: no registry"),
    "train.common.TrainState": (
        "train.common.save_checkpoint",
        "the state is the module and its torch optimizer, saved together"),
    "train.common.global_norm": (
        "train.common.clip_grad_norm",
        "returns the global norm it clips by"),
    "train.ldpc.create_state": (
        "train.common.make_optimizer",
        "init_weights seeds the module; the optimizer holds Adam's state"),
    "train.ldpc.make_train_step": (
        "train.ldpc.train_step", "eager: no step to build and jit"),
    "train.ldpc.make_eval_step": (
        "train.ldpc.decode_step", "eager: no step to build and jit"),
    "train.synthetic.create_state": (
        "train.common.make_optimizer",
        "init_weights seeds the module; the optimizer holds Adam's state"),
    "train.synthetic.make_train_step": (
        "train.synthetic.train_step", "eager: no step to build and jit"),
    "train.synthetic.make_eval_step": (
        "train.synthetic.eval_step", "eager: no step to build and jit"),
    "models.norm.torch_kaiming_uniform": (
        "models.norm.uniform_", "each module's init_ draws U(+-1/sqrt(fan_in))"),
    "models.norm.torch_bias_uniform": (
        "models.norm.uniform_", "each module's init_ draws U(+-1/sqrt(fan_in))"),
    "utils.profiling.enable_compilation_cache": (
        "ops.fused_mp.build",
        "the kernels build once into csrc/build/; nothing else compiles"),
    "train.TrainState": (
        "train.common.save_checkpoint",
        "the state is the module and its torch optimizer, saved together"),
    "utils.enable_compilation_cache": (
        "ops.fused_mp.build",
        "the kernels build once into csrc/build/; nothing else compiles"),
}


def _module_path(pkg: str, dotted: str) -> str:
    parts = dotted.split(".")
    base = os.path.join(REPO, pkg, *parts)
    return base + ".py" if os.path.exists(base + ".py") else os.path.join(
        base, "__init__.py")


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _public_defs(path, imports=False) -> set:
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _all(path):
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _jax_modules():
    """(dotted module, file) of every .py of the JAX package."""
    root = os.path.join(REPO, "fgnn_tpu")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)[:-3]
                yield rel.replace(os.sep, "."), os.path.join(d, f)


def _resolves(target: str) -> bool:
    mod, name = target.rsplit(".", 1)
    path = _module_path("fgnn_tpu_torch", mod)
    return os.path.exists(path) and name in _public_defs(path, True)


def _key(dotted: str, name: str) -> str:
    """The map's key of ``name`` in module ``dotted``: a package's names
    under the package."""
    pkg = dotted.rsplit("__init__", 1)[0] if dotted.endswith(
        "__init__") else dotted + "."
    return pkg + name


def test_every_public_name_has_a_counterpart():
    missing, n = [], 0
    for dotted, path in _jax_modules():
        port = os.path.join(REPO, "fgnn_tpu_torch",
                            os.path.relpath(path, os.path.join(REPO,
                                                               "fgnn_tpu")))
        have = _public_defs(port, True) if os.path.exists(port) else set()
        for name in sorted(_public_defs(path)):
            n += 1
            key = _key(dotted, name)
            if name not in have and key not in COUNTERPARTS:
                missing.append(key)
    assert n > 150
    assert not missing, f"no port counterpart of {missing}"


def test_subpackage_all_is_exported():
    missing, n = [], 0
    for dotted, path in _jax_modules():
        if not dotted.endswith("__init__"):
            continue
        names = _all(path)
        if names is None:
            continue
        port = _all(os.path.join(REPO, "fgnn_tpu_torch",
                                 os.path.relpath(path, os.path.join(
                                     REPO, "fgnn_tpu")))) or set()
        for name in sorted(names):
            n += 1
            key = _key(dotted, name)
            if name not in port and key not in COUNTERPARTS:
                missing.append(key)
    assert n > 100
    assert not missing, f"not in the port's __all__: {missing}"


@pytest.mark.parametrize("name", sorted(COUNTERPARTS))
def test_counterpart_resolves(name):
    target, why = COUNTERPARTS[name]
    assert _resolves(target), f"{name} -> {target} does not resolve"
    assert why and "not needed" not in why.lower()
    mod, leaf = name.rsplit(".", 1)
    jax_path = _module_path("fgnn_tpu", mod)
    assert leaf in _public_defs(jax_path, True), f"{name} is not JAX's"


def test_graft_entry_has_its_port():
    jax = _public_defs(os.path.join(REPO, "__graft_entry__.py"))
    port = _public_defs(os.path.join(REPO, "fgnn_tpu_torch", "entry.py"))
    assert {"entry", "dryrun_multichip"} <= jax
    assert jax <= port
