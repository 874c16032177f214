"""JAX params pytree → the port's torch ``state_dict``.

The JAX package keeps a model's params as a nested dict whose repeated blocks
are stacked on a leading layer axis (``jittor_mlp_tpu/core/pytree.py``,
``models/mlp_mixer.py::_structure``). ``state_dict_from_jax`` undoes that:
it renames the top-level groups back to the torch module names, numbers the
entries of a list (AS-MLP's per-stage ``layers``) and unstacks each stacked
group into ``{prefix}.{i}.…`` (``model.{i}.…``, or AS-MLP's
``layers.{s}.blocks.{i}.…``). Non-parameter leaves (AS-MLP's per-block
drop-path rates ``_dpr``) are dropped. Leaves are given as numpy arrays
(e.g. ``jax.tree.map(np.asarray, model.params)``); this module imports no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# per model: JAX group → torch prefix
_LAYOUT = {
    "mlp_mixer": {"patcher": "patcher.0", "blocks": "model", "active": "active",
                  "head": "mlp_head.0"},
    "res_mlp": {"patcher": "patcher.0", "blocks": "model", "affine": "affine",
                "head": "mlp_head.0"},
    "g_mlp": {"patcher": "patcher.0", "blocks": "model", "head": "mlp_head.0"},
    "as_mlp": {"patch_embed": "patch_embed", "layers": "layers", "norm": "norm",
               "head": "head"},
}
# per model: the torch prefix whose numbered children the JAX package stacks
# into one leaf per parameter ("*" stands for any stage index)
_STACKED = {"mlp_mixer": "model", "res_mlp": "model", "g_mlp": "model",
            "as_mlp": "layers.*.blocks"}
_NON_PARAMS = {"_dpr"}


def _check(name):
    if name not in _LAYOUT:
        raise ValueError(f"no JAX→torch layout for model {name!r}")


def _stacked_len(name, parts):
    """The number of leading key parts that form model ``name``'s stacked
    prefix, or 0 where the key does not start with it."""
    pattern = _STACKED[name].split(".")
    if len(parts) <= len(pattern):
        return 0
    for p, q in zip(pattern, parts):
        if p != q and not (p == "*" and q.isdigit()):
            return 0
    return len(pattern)


def split_stacked(name, key):
    """(prefix, layer index, rest) of a torch key ``{prefix}.{i}.{rest}``
    that lies in model ``name``'s stacked group, else None."""
    _check(name)
    parts = key.split(".")
    n = _stacked_len(name, parts)
    if not n or not parts[n].isdigit() or len(parts) < n + 2:
        return None
    return ".".join(parts[:n]), int(parts[n]), ".".join(parts[n + 1:])


def _flatten(tree, prefix):
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        key = f"{prefix}.{k}"
        if isinstance(v, (dict, list, tuple)):
            yield from _flatten(v, key)
        elif str(k) not in _NON_PARAMS:
            yield key, np.asarray(v)


def state_dict_from_jax(name, params):
    """Flat torch-named ``state_dict`` (CPU tensors) of JAX ``params``."""
    _check(name)
    layout = _LAYOUT[name]
    if set(params) != set(layout):
        raise ValueError(
            f"{name}: JAX groups {sorted(params)} != {sorted(layout)}"
        )
    sd = {}
    for group, prefix in layout.items():
        for key, arr in _flatten(params[group], prefix):
            parts = key.split(".")
            n = _stacked_len(name, parts)
            if n:
                head, rest = ".".join(parts[:n]), ".".join(parts[n:])
                for i in range(arr.shape[0]):
                    sd[f"{head}.{i}.{rest}"] = torch.from_numpy(np.array(arr[i]))
            else:
                sd[key] = torch.from_numpy(np.array(arr))
    return sd
