"""int8 quantization (counterpart of ``jittor_mlp_tpu/quant.py``).

Two schemes, both symmetric:

- **Weight-only int8** (``Predictor(weights="int8")``): every eligible
  weight is stored as int8 with f32 per-channel scales and dequantized once,
  at build, to the compute dtype. ``quantize_state_dict`` applies the JAX
  package's rule to the leaves as *it* holds them: the blocks of a model
  (of each stage, in AS-MLP, S2-MLP and DynaMixer) are one stacked leaf of
  shape (depth, *shape) there, DynaMixer's per-segment projections one of
  (depth, seg, *shape); RaftMLP's, SwinMLP's and ActiveMLP's blocks stay
  apart. So
  eligibility (``ndim ≥ 2`` and ``size ≥ 2048``) and the scale axes are
  decided on the stacked shape. A stacked bias (depth, O) is therefore
  quantized with one scale per layer, a stacked token-mix weight
  (depth, O, I, 1) with one scale per (layer, out-channel), a DynaMixer
  projection (depth, seg, hidden, C) with one per (layer, segment). The
  dequantized weights equal the JAX package's
  ``dequantize_tree(quantize_tree(params))`` bit for bit.
- **Dynamic W8A8** (``int8_mode()``, ``Predictor(compute="int8")``):
  ``dynamic_int8_matmul`` quantizes the live activation per token and the
  weight per output channel and contracts the int8 values exactly.

``exact_int_matmul`` is the exact integer product used by both
``dynamic_int8_matmul`` and the plain twins of the W8A8 kernels: float32
while K·127² < 2²⁴ (K ≤ 1040; int8 values and their sums are exact there,
TF32 included), float64 above.
"""

from __future__ import annotations

import math

import torch

_K_F32_EXACT = 1040  # K·127² < 2**24


def exact_int_matmul(a, b):
    """``a @ b`` for float tensors holding int8 values, exact, as float32
    (the int32 sum rounded once to float32, as ``int32 → f32`` does)."""
    if a.shape[-1] <= _K_F32_EXACT:
        return torch.matmul(a.float(), b.float())
    return torch.matmul(a.double(), b.double()).float()


def quant_weight(w, dim):
    """Per-output-channel int8 weights (``_quant_w``): absmax over ``dim``,
    scale = absmax/127 (1 for an all-zero channel), q = round(w/scale).
    Returns (q as float32 holding ints, f32 scales with ``dim`` kept)."""
    wf = w.float()
    aw = wf.abs().amax(dim=dim, keepdim=True)
    sw = torch.where(aw > 0, aw / 127.0, torch.ones_like(aw))
    return torch.round(wf / sw), sw


def quant_act(xf, dim):
    """Dynamic activation quantization as the W8A8 kernels do it
    (``_quant_act``): absmax over ``dim`` floored at 1e-30, one reciprocal
    rs = 127/absmax, q = round(x·rs), scale = absmax·(1/127). Returns
    (q as float32 holding ints, f32 scales with ``dim`` kept)."""
    ax = torch.clamp_min(xf.abs().amax(dim=dim, keepdim=True), 1e-30)
    rs = 127.0 / ax
    return torch.round(xf * rs), ax * (1.0 / 127.0)


def dynamic_int8_matmul(x, wt):
    """``x @ wt`` as a dynamic W8A8 int8 contraction.

    x: (..., I); wt: (I, O) → (..., O) in x's dtype. Per-token activation
    scales (absmax over I) and per-output-channel weight scales, each
    absmax/127 (1 where the absmax is 0); q = round(v / scale); the int8
    product is exact; the result is acc·sx·sw."""
    xf, wf = x.float(), wt.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(ax > 0, ax / 127.0, torch.ones_like(ax))
    aw = wf.abs().amax(dim=0, keepdim=True)
    sw = torch.where(aw > 0, aw / 127.0, torch.ones_like(aw))
    acc = exact_int_matmul(torch.round(xf / sx), torch.round(wf / sw))
    return (acc * sx * sw).to(x.dtype)


# -- weight-only int8 state dicts ---------------------------------------------


def _quantize_leaf(x):
    """Symmetric per-channel int8 of one (possibly stacked) leaf: scales over
    the leading two axes when each scale still covers ≥ 8 weights, else over
    axis 0 only (``jittor_mlp_tpu/quant.py::_quantize_leaf``)."""
    xf = x.float()
    n_scale = 2 if xf.dim() >= 3 and math.prod(xf.shape[2:]) >= 8 else 1
    absmax = xf.abs().amax(dim=tuple(range(n_scale, xf.dim())), keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _eligible(x, min_size):
    return x.is_floating_point() and x.dim() >= 2 and x.numel() >= min_size


def _leaves(name, sd):
    """Group a torch state dict into the JAX package's leaves
    (``convert.leaf_of``): keys of a stacked group (``model.{i}.…``, AS-MLP's
    ``layers.{s}.blocks.{i}.…``) with the same prefix and rest form one
    leaf, layers in order; DynaMixer's ``Wd.{k}`` of every layer of a stage
    form one (layer, segment) leaf. Yields (list of torch keys, leaf tensor,
    stacked?)."""
    from .convert import leaf_of

    groups = {}
    for key in sd:
        leaf, idx = leaf_of(name, key)
        if not idx:
            yield [key], sd[key], False
        else:
            groups.setdefault(leaf, []).append((idx, key))
    for members in groups.values():
        members.sort()
        keys = [k for _, k in members]
        leaf = torch.stack([sd[k] for k in keys])
        shape = [len({idx[a] for idx, _ in members}) for a in range(len(members[0][0]))]
        yield keys, leaf.reshape(*shape, *leaf.shape[1:]), True


def quantize_state_dict(name, sd, min_size=2048):
    """int8 state dict of model ``name`` (a zoo key such as "mlp_mixer"):
    key → {"q": int8 tensor, "scale": f32 tensor} for quantized weights,
    else the tensor unchanged. Eligibility and scale axes follow the JAX
    package's stacked leaves; each key keeps its own layer's slice. Keys
    the JAX params do not hold (``convert.jax_dropped``: CycleFC offsets,
    Hire-MLP's unused last merge) are never quantized, as in JAX."""
    from .convert import jax_dropped

    dropped = jax_dropped(name, sd)
    out = {}
    for keys, leaf, stacked in _leaves(name, sd):
        if keys[0] in dropped or not _eligible(leaf, min_size):
            out.update((k, sd[k]) for k in keys)
        elif not stacked:
            q, scale = _quantize_leaf(leaf)
            out[keys[0]] = {"q": q, "scale": scale}
        else:  # a key for each index of the leading (layer[, segment]) axes, in order
            q, scale = _quantize_leaf(leaf)
            kdim = sd[keys[0]].dim()
            q = q.reshape(len(keys), *q.shape[leaf.dim() - kdim:])
            scale = scale.reshape(len(keys), *scale.shape[leaf.dim() - kdim:])
            out.update((k, {"q": q[i], "scale": scale[i]}) for i, k in enumerate(keys))
    return out


def dequantize_state_dict(qsd, dtype):
    """Inverse of ``quantize_state_dict``: int8·scale → dtype; other
    floating-point tensors are cast to dtype, the rest left as they are."""
    out = {}
    for k, v in qsd.items():
        if isinstance(v, dict):
            out[k] = (v["q"].float() * v["scale"]).to(dtype)
        elif v.is_floating_point():
            out[k] = v.to(dtype)
        else:
            out[k] = v
    return out
