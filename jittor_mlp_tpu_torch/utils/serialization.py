"""Checkpoints: model params and the full train state (counterpart of
``jittor_mlp_tpu/utils/serialization.py``).

- ``save_params`` / ``load_params``: a single-file ``.npz`` snapshot keyed
  by ``state_dict`` name. ``load_params`` also reads a snapshot that the
  JAX package's ``save_params`` wrote (``leaf_00000…`` arrays in JAX's
  flatten order and the printed ``__treedef__``): ``jax_tree`` rebuilds the
  nested params without JAX and ``convert.state_dict_from_jax`` names them.
- ``save_train_state`` / ``restore_train_state``: ``torch.save`` of the
  model's and the optimizer's ``state_dict`` (BatchNorm buffers included),
  the step and a generator's state, in place of the JAX package's orbax
  checkpoint.
"""

from __future__ import annotations

import ast
import os

import numpy as np
import torch

_LEAF = "__jax_leaf__"  # stands for each ``*`` of a printed PyTreeDef


def host_array(t):
    """A state-dict tensor as numpy on the host: bf16 as float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_raw_bf16(a):
    """A JAX bfloat16 leaf (``ml_dtypes.bfloat16``, which numpy reads back as
    raw 2-byte records) as the float32 array of the same values; any other
    array as it is."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def parse_treedef(text):
    """The nested dicts, lists and tuples of a printed JAX ``PyTreeDef``
    (``PyTreeDef({'a': {'b': *}, 'c': [*, None]})``), each ``*`` (a leaf)
    replaced by the sentinel ``_LEAF``; ``None`` stays an empty node."""
    text = text.strip()
    if not (text.startswith("PyTreeDef(") and text.endswith(")")):
        raise ValueError(f"not a printed PyTreeDef: {text[:60]!r}")
    return ast.literal_eval(text[len("PyTreeDef("):-1].replace("*", repr(_LEAF)))


def fill_leaves(tree, leaves):
    """``tree`` (from ``parse_treedef``) with its sentinels replaced by
    ``leaves`` in JAX's flatten order: dict keys sorted, lists and tuples
    in order, ``None`` holding none."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        if node != _LEAF:
            raise ValueError(f"unexpected node {node!r} in a PyTreeDef")
        return next(it)

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def jax_tree(data):
    """The nested params of a JAX ``save_params``-style ``np.load`` result:
    ``__treedef__`` filled with the ``leaf_NNNNN`` arrays (bfloat16 leaves as
    float32 of the same values)."""
    tree = parse_treedef(str(data["__treedef__"]))
    n = sum(k.startswith("leaf_") for k in data.files)
    return fill_leaves(tree, [_from_raw_bf16(data[f"leaf_{i:05d}"]) for i in range(n)])


def is_jax_file(data):
    return "__treedef__" in data.files


def from_jax_tree(model, params):
    """torch ``state_dict`` of model from JAX ``params`` (numpy leaves):
    ``convert.state_dict_from_jax`` with the model's own state dict as the
    template for the keys the JAX params do not hold."""
    from ..convert import state_dict_from_jax

    return state_dict_from_jax(model.name, params, template=model.state_dict())


def save_params(model, path):
    """Snapshot ``model.state_dict()`` to an ``.npz`` keyed by name
    (bf16 tensors stored as float32, exactly). Returns ``path``."""
    np.savez(path, **{k: host_array(v) for k, v in model.state_dict().items()})
    return path


def load_params(model, path):
    """Restore a ``save_params`` snapshot into an identically-built model,
    strictly, in the model's dtypes and on its device. Reads the port's own
    files and the JAX package's ``save_params`` files."""
    with np.load(path) as data:
        if is_jax_file(data):
            sd = from_jax_tree(model, jax_tree(data))
        else:
            sd = {k: torch.from_numpy(data[k]) for k in data.files}
    return model.load_torch_state_dict(sd)


def save_train_state(path, model, optimizer, step, generator=None, model_state=None,
                     optimizer_state=None):
    """``torch.save`` of the model's and the optimizer's state dicts, the
    step and ``generator``'s state (if given). Returns the absolute path.
    ``model_state`` and ``optimizer_state`` replace ``model.state_dict()``
    and ``optimizer.state_dict()`` (a pipelined model's
    ``parallel.gather_state_dict`` and ``gather_optimizer_state``)."""
    path = os.path.abspath(path)
    torch.save({"model": model.state_dict() if model_state is None else model_state,
                "optimizer": (optimizer.state_dict() if optimizer_state is None
                              else optimizer_state),
                "step": int(step),
                "generator": None if generator is None else generator.get_state()}, path)
    return path


def restore_train_state(path, model, optimizer, generator=None):
    """Load a ``save_train_state`` checkpoint into ``model``, ``optimizer``
    and ``generator`` (each built as at save time) in place; returns the
    step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    if generator is not None:
        if state["generator"] is None:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(state["generator"])
    return state["step"]
