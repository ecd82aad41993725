"""Read the JAX package's checkpoints (counterpart of the checkpoint half of
``fgnn_tpu/train/common.py``) into the port's models and torch Adam.

The JAX trainers pickle a plain dict: ``format_version`` (2, or none in
the oldest files), ``opt_layout`` (``"tree"``, or ``"flat"`` where the
optimizer ran under ``optax.flatten``; absent means ``"flat"``),
``params`` and ``batch_stats`` (nested dicts of numpy arrays), the optax
``opt_state``, ``gcnt``, ``epoch`` and ``extra``.  A file of ``params``
and ``batch_stats`` alone decodes but cannot resume training.

``opt_state`` is a tuple chain of optax states: the LDPC trainer's
``(EmptyState(), InjectStatefulHyperparamsState(count, hyperparams,
hyperparams_states, (ScaleByAdamState(count, mu, nu), EmptyState())))``,
the synthetic trainers' with the clip's ``EmptyState`` in front.  In the
``"tree"`` layout ``mu`` and ``nu`` are trees shaped like ``params``; in
the ``"flat"`` layout single vectors over every parameter, in the order of
``optax.flatten``'s ravel (the dict keys sorted at every level).

Unpickling can run code, and a plain ``pickle.load`` of these files would
import optax.  So ``JaxUnpickler`` resolves only the globals such a file
names, to numpy's own functions and to plain stand-ins of the optax state
classes, and refuses any other global with ``ValueError``; nothing of JAX
is imported.
"""

from __future__ import annotations

import pickle
from collections import namedtuple
from typing import Mapping

import numpy as np
import torch

from ..models.from_jax import flax_tensors, load_flax_variables

JAX_FORMAT_VERSION = 2

# Stand-ins of the optax state classes, with their positional fields: a
# pickled NamedTuple is rebuilt as cls.__new__(cls, *fields).
EmptyState = namedtuple("EmptyState", ())
ScaleByAdamState = namedtuple("ScaleByAdamState", ("count", "mu", "nu"))
InjectStatefulHyperparamsState = namedtuple(
    "InjectStatefulHyperparamsState",
    ("count", "hyperparams", "hyperparams_states", "inner_state"))
InjectHyperparamsState = namedtuple(
    "InjectHyperparamsState", ("count", "hyperparams", "inner_state"))

# numpy's own array reconstructor, whichever module this numpy keeps it in
_RECONSTRUCT = np.zeros(0).__reduce__()[0]

# (module, name) -> object: every global a JAX checkpoint names, in the
# spellings of numpy 1 and 2 and of the optax releases that wrote them
ALLOWED_GLOBALS = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy._core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy.core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"):
        InjectStatefulHyperparamsState,
    ("optax.schedules._inject", "InjectHyperparamsState"):
        InjectHyperparamsState,
}


class JaxUnpickler(pickle.Unpickler):
    """An unpickler that builds only numpy arrays, plain containers and the
    optax state stand-ins (``ALLOWED_GLOBALS``)."""

    def find_class(self, module, name):
        try:
            return ALLOWED_GLOBALS[(module, name)]
        except KeyError:
            raise ValueError(
                f"refusing to unpickle the global {module}.{name}: a JAX "
                "checkpoint names only numpy arrays and optax states") \
                from None


def is_jax_checkpoint(payload) -> bool:
    return isinstance(payload, dict) and isinstance(payload.get("params"),
                                                    Mapping)


def read_jax_checkpoint(path: str) -> dict:
    """The payload of a JAX checkpoint, its ``opt_layout`` filled in
    (``"flat"`` where the file has none).  Raises ``ValueError`` for a
    global outside ``ALLOWED_GLOBALS``, another format version, or a file
    that is not such a payload."""
    with open(path, "rb") as f:
        try:
            payload = JaxUnpickler(f).load()
        except (pickle.UnpicklingError, EOFError) as e:
            raise ValueError(f"{path} is not a JAX checkpoint: {e}") from e
    if not is_jax_checkpoint(payload):
        raise ValueError(f"{path} is not a JAX checkpoint (a dict with "
                         "params)")
    version = payload.get("format_version")
    if version is not None and version != JAX_FORMAT_VERSION:
        raise ValueError(f"{path} has format version {version}; this build "
                         f"reads JAX checkpoints of version "
                         f"{JAX_FORMAT_VERSION}")
    return {**payload, "opt_layout": payload.get("opt_layout", "flat")}


def _adam_states(state):
    """Every ``ScaleByAdamState`` in an opt_state, at any depth."""
    if isinstance(state, ScaleByAdamState):
        return [state]
    if isinstance(state, Mapping):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _adam_states(s)]
    return []


def _ravel_order(tree: Mapping, prefix=()):
    """(path, shape) of every leaf of ``tree`` in ``optax.flatten``'s
    order: the keys sorted at every level."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from _ravel_order(val, prefix + (key,))
        else:
            yield prefix + (key,), np.shape(val)


def _moments(model, moment, params: Mapping, layout: str, state) -> dict:
    """One Adam moment (``mu`` or ``nu``) as port parameter name ->
    tensor, through the parameters' leaf map."""
    found = "tree" if isinstance(moment, Mapping) else "flat"
    if found != layout:
        raise ValueError(f"opt_state is tagged {layout!r} but its moments "
                         f"are in the {found!r} layout")
    if found == "flat":
        vec = np.asarray(moment)
        order = list(_ravel_order(params))
        sizes = [int(np.prod(shape)) for _, shape in order]
        if vec.ndim != 1 or vec.size != sum(sizes):
            raise ValueError(f"flat opt_state: a moment of shape "
                             f"{vec.shape}, where the params hold "
                             f"{sum(sizes)} elements")
        moment = [(path, part.reshape(shape)) for (path, shape), part in
                  zip(order, np.split(vec, np.cumsum(sizes)[:-1]))]
    return flax_tensors(model, "params", moment, state)


def restore_jax_payload(payload: dict, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer = None):
    """Fill ``model`` from a JAX checkpoint's ``params`` and
    ``batch_stats`` (``load_flax_variables``, strict), and with
    ``optimizer`` (torch Adam over the model's parameters) its state from
    the one ``ScaleByAdamState`` of ``opt_state``: ``step`` from its
    count, ``exp_avg`` from ``mu``, ``exp_avg_sq`` from ``nu``, each on its
    parameter's device.  The LR is not taken from the file: the trainers
    set it from their schedule every epoch.  Returns (epoch, gcnt)."""
    load_flax_variables(model, {c: payload[c] for c in
                                ("params", "batch_stats") if c in payload})
    if optimizer is not None:
        if "opt_state" not in payload:
            raise ValueError("the JAX checkpoint holds params only, no "
                             "opt_state: it decodes but cannot resume "
                             "training")
        _restore_adam(payload, model, optimizer)
    return int(payload.get("epoch", 0)), int(payload.get("gcnt", 0))


def _restore_adam(payload, model, optimizer):
    adam = _adam_states(payload["opt_state"])
    if len(adam) != 1:
        raise ValueError(f"opt_state holds {len(adam)} ScaleByAdamState; "
                         "a JAX trainer's holds one")
    (adam,) = adam
    state = model.state_dict()
    layout = payload.get("opt_layout", "flat")
    mu, nu = (_moments(model, m, payload["params"], layout, state)
              for m in (adam.mu, adam.nu))
    names = {id(p): n for n, p in model.named_parameters()}
    saved = optimizer.state_dict()
    restored, used = {}, set()
    for group, saved_group in zip(optimizer.param_groups,
                                  saved["param_groups"]):
        for p, index in zip(group["params"], saved_group["params"]):
            name = names.get(id(p))
            if name not in mu:
                raise ValueError(f"optimizer parameter {name or index} has "
                                 "no Adam state in the JAX checkpoint")
            restored[index] = {"step": torch.tensor(float(adam.count)),
                               "exp_avg": mu[name],
                               "exp_avg_sq": nu[name]}
            used.add(name)
    if used != set(mu):
        raise ValueError(f"Adam state for parameters the optimizer does not "
                         f"hold: {sorted(set(mu) - used)}")
    optimizer.load_state_dict({"state": restored,
                               "param_groups": saved["param_groups"]})
