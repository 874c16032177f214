"""JAX params pytree → the port's torch ``state_dict``.

The JAX package keeps a model's params as a nested dict whose repeated blocks
are stacked on a leading layer axis (``jittor_mlp_tpu/core/pytree.py``,
``models/mlp_mixer.py::_structure``). ``state_dict_from_jax`` undoes that:
it renames the top-level groups back to the torch module names, numbers the
entries of a list (AS-MLP's per-stage ``layers``, RaftMLP's per-block
lists), renames what a model's ``_structure`` renamed inside its groups
(``_RENAME``: S2-MLP's and DynaMixer's ``patch`` and ``blocks``, RaftMLP's
``embed`` and block ``j`` = ``fn.{2+j}``, DynaMixer's ``op_h`` and
``attend``), unstacks each stacked group into ``{prefix}.{i}.…``
(``model.{i}.…``, or AS-MLP's ``layers.{s}.blocks.{i}.…``) and, inside a
DynaMixer block, the per-segment projections stacked as ``wd_w`` / ``wd_b``
(seg, …) into ``Wd.{s}.weight`` / ``.bias``. Non-parameter leaves (AS-MLP's
per-block drop-path rates ``_dpr``) are dropped. Leaves are given as numpy
arrays (e.g. ``jax.tree.map(np.asarray, model.params)``); this module
imports no JAX.

``leaf_of`` maps a torch key back to the JAX leaf that holds it (and its
place there), which ``quant.quantize_state_dict`` groups by.
"""

from __future__ import annotations

import re

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
    "vip": {"patcher": "patcher.0", "blocks": "blocks.model", "head_norm": "mlp_head.0",
            "head": "mlp_head.2"},
    "s2_mlp_v1": {"stages": "stages", "head": "mlp_head.1"},
    "s2_mlp_v2": {"stages": "stages", "head": "mlp_head.1"},
    "raft_mlp": {"levels": "levels", "heads": "heads", "classifier": "classifier"},
    "swin_mlp": {"patch_embed": "patch_embed", "layers": "layers", "norm": "norm",
                 "head": "head", "absolute_pos_embed": "absolute_pos_embed"},
    "dyna_mlp": {"stages": "stages", "head": "mlp_head.1"},
}
_OPTIONAL = {"swin_mlp": {"absolute_pos_embed"}}  # groups a model has only with an option
_STAGES = [(r"^stages\.(\d+)\.patch\.", r"stages.\1.0.")]
# per model: (pattern, replacement) applied in turn to each key after the
# group's prefix, before unstacking
_RENAME = {
    "s2_mlp_v1": _STAGES + [(r"^stages\.(\d+)\.blocks\.", r"stages.\1.1.model.")],
    "s2_mlp_v2": _STAGES + [(r"^stages\.(\d+)\.blocks\.", r"stages.\1.1.model.")],
    "raft_mlp": [(r"^levels\.(\d+)\.embed\.", r"levels.\1.fn.1."),
                 (r"^levels\.(\d+)\.blocks\.(\d+)\.",
                  lambda m: f"levels.{m[1]}.fn.{2 + int(m[2])}.")],
    "dyna_mlp": _STAGES + [(r"^stages\.(\d+)\.blocks\.", r"stages.\1.1.layers."),
                           (r"\.op_([hw])\.", r".DynaMixerOp_\1."),
                           (r"\.attend\.", ".attend.1.")],
}
# per model: the torch prefix whose numbered children the JAX package stacks
# into one leaf per parameter ("*" stands for any stage index)
_STACKED = {"mlp_mixer": "model", "res_mlp": "model", "g_mlp": "model",
            "as_mlp": "layers.*.blocks", "vip": "blocks.model",
            "s2_mlp_v1": "stages.*.1.model", "s2_mlp_v2": "stages.*.1.model",
            "dyna_mlp": "stages.*.1.layers"}  # RaftMLP and SwinMLP keep per-block lists
# per model: a leaf of each stacked layer that stacks a numbered group again
# (DynaMixer's per-segment projections): JAX name → torch name, {} the index
_SEGMENTED = {"dyna_mlp": {"wd_w": "Wd.{}.weight", "wd_b": "Wd.{}.bias"}}
_NON_PARAMS = {"_dpr"}


def _check(name):
    if name not in _LAYOUT:
        raise ValueError(f"no JAX→torch layout for model {name!r}")


def _stacked_len(name, parts):
    """The number of leading key parts that form model ``name``'s stacked
    prefix, or 0 where the key does not start with it."""
    if name not in _STACKED:
        return 0
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


def _segment_of(name, rest):
    """(rest with the segment index as "{}", segment index) where ``rest``
    (a key after its layer index) is one of a segmented group, else None."""
    for torch_name in _SEGMENTED.get(name, {}).values():
        pattern = re.escape(torch_name).replace(r"\{\}", r"(\d+)")
        m = re.search(r"(^|\.)" + pattern + "$", rest)
        if m:
            return rest[:m.start(2)] + "{}" + rest[m.end(2):], int(m[2])
    return None


def leaf_of(name, key):
    """(leaf id, index) of torch ``key`` among the JAX package's leaves of
    model ``name``: the index is () where the key is a leaf of its own,
    (layer,) in a stacked group, (layer, segment) in a segmented one. Keys
    with the same leaf id form one leaf, stacked in index order."""
    split = split_stacked(name, key)
    if split is None:
        return key, ()
    prefix, idx, rest = split
    seg = _segment_of(name, rest)
    if seg is not None:
        return (prefix, seg[0]), (idx, seg[1])
    return (prefix, rest), (idx,)


def _rename(name, key):
    for pattern, repl in _RENAME.get(name, ()):
        key = re.sub(pattern, repl, key)
    return key


def _flatten(tree, prefix):
    if not isinstance(tree, (dict, list, tuple)):
        yield prefix, np.asarray(tree)
        return
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
    required = set(layout) - _OPTIONAL.get(name, set())
    if not required <= set(params) <= set(layout):
        raise ValueError(
            f"{name}: JAX groups {sorted(params)} != {sorted(layout)}"
        )
    segmented = _SEGMENTED.get(name, {})
    sd = {}
    for group, prefix in layout.items():
        if group not in params:
            continue
        for key, arr in _flatten(params[group], prefix):
            key = _rename(name, key)
            parts = key.split(".")
            n = _stacked_len(name, parts)
            if not n:
                sd[key] = torch.from_numpy(np.array(arr))
                continue
            head, rest = ".".join(parts[:n]), ".".join(parts[n:])
            *path, last = rest.split(".")
            for i in range(arr.shape[0]):
                if last in segmented:
                    for s in range(arr.shape[1]):
                        k = ".".join([head, str(i), *path, segmented[last].format(s)])
                        sd[k] = torch.from_numpy(np.array(arr[i, s]))
                else:
                    sd[f"{head}.{i}.{rest}"] = torch.from_numpy(np.array(arr[i]))
    return sd
