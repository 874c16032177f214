"""JAX params pytree → the port's torch ``state_dict``.

The JAX package keeps a model's params as a nested dict whose repeated blocks
are stacked on a leading layer axis (``jittor_mlp_tpu/core/pytree.py``,
``models/mlp_mixer.py::_structure``). ``state_dict_from_jax`` undoes that:
it renames the top-level groups back to the torch module names, numbers the
entries of a list (AS-MLP's per-stage ``layers``, RaftMLP's per-block
lists), renames what a model's ``_structure`` renamed inside its groups
(``_RENAME``: S2-MLP's, DynaMixer's and Sequencer's ``patch`` and
``blocks``, RaftMLP's ``embed`` and block ``j`` = ``fn.{2+j}``,
DynaMixer's ``op_h`` and ``attend``, GFNetPyramid's ``patch_embed.{i}``
= ``patch_embed.{i}.proj``), unstacks each stacked group into
``{prefix}.{i}.…`` (``model.{i}.…``, or AS-MLP's
``layers.{s}.blocks.{i}.…``, GFNetPyramid's ``blocks.{s}.{j}.…``) and, inside a
DynaMixer block, the per-segment projections stacked as ``wd_w`` / ``wd_b``
(seg, …) into ``Wd.{s}.weight`` / ``.bias``. Non-parameter leaves (AS-MLP's
per-block drop-path rates ``_dpr``) are dropped. Leaves are given as numpy
arrays (e.g. ``jax.tree.map(np.asarray, model.params)``); this module
imports no JAX.

Before that, a model's ``_PREPARE`` step puts back what the JAX
``_structure`` took apart: the stages and transitions of CycleMLP,
MorphMLP and WaveMLP go back into the reference's ``network`` slots (a
transition's ``proj`` and ``norm`` sit in slots of the stacked list, so
``_NOT_STACKED`` names them), each CycleFC gets its ``offset`` buffer
again, made from the weight's width, and RepMLPNet's ``deploy`` flag leaf
goes. Hire-MLP's ``_step`` and ConvMLP's ``_dpr`` are dropped as
non-parameter leaves.

Some keys of a reference state dict are not in the JAX params at all
(``jax_dropped``): every BatchNorm's ``num_batches_tracked``, the CycleFC
offsets, and the last ``patch_merge`` of Hire-MLP and SparseMLP, which the
reference holds and never runs. JAX's export makes the first again (int64
0) and takes the others from its init template; ``state_dict_from_jax``
makes the counters and offsets again and takes the others from its
``template`` argument, and ``quant`` keeps them out of int8, as JAX never
quantizes them.

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
    "ms_mlp": {"patch_embed": "patch_embed", "layers": "layers", "norm": "norm", "head": "head"},
    "hire_mlp": {"patcher": "patcher.reduction.0", "patcher_norm": "patcher.reduction.1.1",
                 "stages": "layers", "head_norm": "mlp_head.0", "head": "mlp_head.2"},
    "cycle_mlp": {"patch_embed": "patch_embed.proj", "network": "network", "norm": "norm",
                  "head": "head"},
    "active_mlp": {"patch_embed": "patch_embed.proj", "blocks": "blocks",
                   "pos_blocks": "pos_blocks", "norm": "norm", "head": "head"},
    "conv_mixer": {"embedding": "embedding", "blocks": "blocks", "head": "classifier.2"},
    "sparse_mlp": {"patcher": "patcher.0", "patcher_norm": "patcher.1.1", "stages": "layers",
                   "head_norm": "mlp_head.1", "head": "mlp_head.3"},
    "morph_mlp": {"patch_embed": "patch_embed", "network": "network", "norm": "norm",
                  "head": "head"},
    "wave_mlp": {"patch_embed": "patch_embed", "network": "network", "norm": "norm",
                 "head": "head"},
    "conv_mlp": {"tokenizer": "tokenizer", "conv_stages": "conv_stages", "stages": "stages",
                 "norm": "norm", "head": "head"},
    "repmlpnet": {"conv_embedding": "conv_embedding", "stages": "stages", "embeds": "embeds",
                  "head_norm": "head_norm", "head": "head"},
    "gfnet": {"patch_embed": "patch_embed.proj", "pos_embed": "pos_embed", "blocks": "blocks",
              "norm": "norm", "pre_logits": "pre_logits", "head": "head"},
    "gfnet_pyramid": {"patch_embed": "patch_embed", "pos_embed": "pos_embed", "blocks": "blocks",
                      "norm": "norm", "head": "head"},
    "sequencer": {"stages": "stages", "head": "mlp_head.1"},
}
# groups a model has only with an option
_OPTIONAL = {"swin_mlp": {"absolute_pos_embed"}, "hire_mlp": {"patcher_norm"},
             "sparse_mlp": {"patcher_norm"}, "conv_mlp": {"norm", "head"},
             "gfnet": {"pre_logits"}}
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
    "hire_mlp": [(r"^layers\.(\d+)\.blocks\.", r"layers.\1.model."),
                 (r"^layers\.(\d+)\.merge\.", r"layers.\1.patch_merge.1.reduction.0.")],
    "active_mlp": [(r"^pos_blocks\.(\d+)\.", r"pos_blocks.\1.proj.")],
    "sparse_mlp": [(r"^layers\.(\d+)\.blocks\.", r"layers.\1.model."),
                   (r"^layers\.(\d+)\.merge\.", r"layers.\1.patch_merge.1.")],
    "conv_mlp": [(r"^stages\.(\d+)\.downsample\.", r"stages.\1.downsample_mlp.downsample.")],
    "repmlpnet": [(r"^stages\.(\d+)\.blocks\.", r"stages.\1.")],
    "gfnet_pyramid": [(r"^patch_embed\.(\d+)\.", r"patch_embed.\1.proj.")],
    "sequencer": _STAGES + [(r"^stages\.(\d+)\.blocks\.", r"stages.\1.1.model.")],
}
# per model: the torch prefix whose numbered children the JAX package stacks
# into one leaf per parameter ("*" stands for any stage index)
_STACKED = {"mlp_mixer": "model", "res_mlp": "model", "g_mlp": "model",
            "as_mlp": "layers.*.blocks", "vip": "blocks.model",
            "s2_mlp_v1": "stages.*.1.model", "s2_mlp_v2": "stages.*.1.model",
            "dyna_mlp": "stages.*.1.layers", "ms_mlp": "layers.*.blocks",
            "hire_mlp": "layers.*.model", "cycle_mlp": "network.*", "conv_mixer": "blocks",
            "sparse_mlp": "layers.*.model", "morph_mlp": "network.*", "wave_mlp": "network.*",
            "conv_mlp": "stages.*.blocks", "repmlpnet": "stages.*", "gfnet": "blocks",
            "gfnet_pyramid": "blocks.*", "sequencer": "stages.*.1.model"}
# RaftMLP, SwinMLP and ActiveMLP keep per-block lists
# per model: keys under a stacked prefix that are not stacked (the
# transitions of CycleMLP, MorphMLP and WaveMLP, in the slots between their
# stages)
_NOT_STACKED = {"cycle_mlp": ("network.*.proj",),
                "morph_mlp": ("network.*.proj", "network.*.norm"),
                "wave_mlp": ("network.*.proj", "network.*.norm")}
# per model: a leaf of each stacked layer that stacks a numbered group again
# (DynaMixer's per-segment projections): JAX name → torch name, {} the index
_SEGMENTED = {"dyna_mlp": {"wd_w": "Wd.{}.weight", "wd_b": "Wd.{}.bias"}}
_NON_PARAMS = {"_dpr", "_step"}


def _check(name):
    if name not in _LAYOUT:
        raise ValueError(f"no JAX→torch layout for model {name!r}")


def _prefix_len(pattern, parts):
    """The number of parts of ``pattern`` ("*" for any index) where the key
    ``parts`` starts with it and goes on, else 0."""
    pattern = pattern.split(".")
    if len(parts) <= len(pattern):
        return 0
    for p, q in zip(pattern, parts):
        if p != q and not (p == "*" and q.isdigit()):
            return 0
    return len(pattern)


def _stacked_len(name, parts):
    """The number of leading key parts that form model ``name``'s stacked
    prefix, or 0 where the key does not start with it."""
    if name not in _STACKED or any(_prefix_len(p, parts) for p in _NOT_STACKED.get(name, ())):
        return 0
    return _prefix_len(_STACKED[name], parts)


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


def _network(params, down=lambda d: d):
    """JAX stages → the reference's ``network``: stage i's stacked blocks in
    a slot, its transition ``down(st["down"])`` in the next where it has
    one (MorphMLP, WaveMLP; CycleMLP's)."""
    net = {}
    for st in params["stages"]:
        net[str(len(net))] = st["blocks"]
        if "down" in st:
            net[str(len(net))] = down(st["down"])
    return {**{g: v for g, v in params.items() if g != "stages"}, "network": net}


def _cycle_network(params):
    """CycleMLP's ``network``: the transition is ``{"proj": conv}``; each
    CycleFC (stacked weight (depth, C, C, 1, 1)) gets its ``offset`` buffer
    again."""
    from .ops.deform import cycle_offset

    stages = []
    for st in params["stages"]:
        attn = dict(st["blocks"]["attn"])
        for sfc, (kh, kw) in (("sfc_h", (1, 3)), ("sfc_w", (3, 1))):
            depth, c = np.shape(attn[sfc]["weight"])[:3:2]
            attn[sfc] = {**attn[sfc], "offset": np.stack([cycle_offset(c, kh, kw)] * depth)}
        stages.append({**st, "blocks": {**st["blocks"], "attn": attn}})
    return _network({**params, "stages": stages}, lambda d: {"proj": d})


# per model: JAX params → params in the reference's groups
_PREPARE = {"cycle_mlp": _cycle_network, "morph_mlp": _network, "wave_mlp": _network,
            # deploy checkpoints: the presence flag the JAX importer plants
            "repmlpnet": lambda params: {g: v for g, v in params.items() if g != "deploy"}}
# per model: what of ``jax_dropped`` only a template can give
_NEEDS_TEMPLATE = {"hire_mlp": "the last stage's patch_merge",
                   "sparse_mlp": "the last stage's patch_merge"}


def jax_dropped(name, keys):
    """The keys among ``keys`` (a torch state dict's) of model ``name``
    that the JAX params do not hold: every BatchNorm's
    ``num_batches_tracked``, each CycleFC's ``offset`` buffer, and the last
    ``patch_merge`` of Hire-MLP and SparseMLP (the reference's, never
    run)."""
    _check(name)
    dropped = {k for k in keys if k.endswith(".num_batches_tracked")}
    if name == "cycle_mlp":
        dropped |= {k for k in keys if k.endswith(".offset")}
    if name in ("hire_mlp", "sparse_mlp"):
        last = max(int(m[1]) for k in keys if (m := re.match(r"layers\.(\d+)\.", k)))
        dropped |= {k for k in keys if k.startswith(f"layers.{last}.patch_merge.")}
    return dropped


def state_dict_from_jax(name, params, template=None):
    """Flat torch-named ``state_dict`` (CPU tensors) of JAX ``params``.
    Every BatchNorm gets its ``num_batches_tracked`` (int64 0, as JAX's
    export writes it). The keys that the JAX params do not hold and that
    cannot be made again (the last ``patch_merge`` of Hire-MLP and
    SparseMLP; ``jax_dropped``) come from ``template``, a state dict of the
    same model (JAX's export takes them from its init template): without
    one they raise."""
    _check(name)
    if name in _PREPARE:
        params = _PREPARE[name](params)
    sd = _from_params(name, params)
    for k in [k for k in sd if k.endswith(".running_var")]:  # as JAX's export makes it again
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    if template is None:
        if name in _NEEDS_TEMPLATE:
            raise ValueError(f"{name}: the JAX params do not hold {_NEEDS_TEMPLATE[name]}; "
                             f"pass template=, a state dict of the model")
        return sd
    for k in sorted(jax_dropped(name, template) - set(sd)):
        v = template[k]
        sd[k] = v.detach().cpu().clone() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
    return sd


def _from_params(name, params):
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
