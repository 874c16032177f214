"""JAX params pytree → the port's torch ``state_dict``.

The JAX package keeps a model's params as a nested dict whose repeated blocks
are stacked on a leading layer axis (``jittor_mlp_tpu/core/pytree.py``,
``models/mlp_mixer.py::_structure``). ``state_dict_from_jax`` undoes that:
it renames the top-level groups back to the torch module names and unstacks
``blocks`` into ``model.{i}.…``. Leaves are given as numpy arrays (e.g.
``jax.tree.map(np.asarray, model.params)``); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# per model: JAX group → (torch prefix, stacked over layers?)
_LAYOUT = {
    "mlp_mixer": {
        "patcher": ("patcher.0", False),
        "blocks": ("model", True),
        "active": ("active", False),
        "head": ("mlp_head.0", False),
    },
    "res_mlp": {
        "patcher": ("patcher.0", False),
        "blocks": ("model", True),
        "affine": ("affine", False),
        "head": ("mlp_head.0", False),
    },
    "g_mlp": {
        "patcher": ("patcher.0", False),
        "blocks": ("model", True),
        "head": ("mlp_head.0", False),
    },
}


def stacked_prefixes(name):
    """Torch prefixes whose numbered children the JAX package stacks into
    one leaf per parameter (e.g. {"model"} for ``model.{i}.…``)."""
    if name not in _LAYOUT:
        raise ValueError(f"no JAX→torch layout for model {name!r}")
    return {prefix for prefix, stacked in _LAYOUT[name].values() if stacked}


def _flatten(tree, prefix):
    for k, v in tree.items():
        key = f"{prefix}.{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, np.asarray(v)


def state_dict_from_jax(name, params):
    """Flat torch-named ``state_dict`` (CPU tensors) of JAX ``params``."""
    if name not in _LAYOUT:
        raise ValueError(f"no JAX→torch layout for model {name!r}")
    layout = _LAYOUT[name]
    if set(params) != set(layout):
        raise ValueError(
            f"{name}: JAX groups {sorted(params)} != {sorted(layout)}"
        )
    sd = {}
    for group, (prefix, stacked) in layout.items():
        for key, arr in _flatten(params[group], prefix):
            if stacked:
                head, rest = key.split(".", 1)
                for i in range(arr.shape[0]):
                    sd[f"{head}.{i}.{rest}"] = torch.from_numpy(np.array(arr[i]))
            else:
                sd[key] = torch.from_numpy(np.array(arr))
    return sd
