"""Functional NN primitives on torch tensors (subset of ``jittor_mlp_tpu/core/nnf.py``).

Each function takes the activation first and the torch-layout weights as
tensors, in the style of ``torch.nn.functional``:

- Linear:    weight (out, in)        — applied as x @ W^T (+ b)
- Conv1d k1: weight (out, in, 1)     — token mixing over axis -2
- Conv2d:    weight (O, I/g, kh, kw) — ``conv2d`` and patch embedding of
  NHWC activations
- Norms:     weight/bias (C,)        — channel-last

The rounding points are those of the JAX package, so the two agree on the
same weights: bf16 GELU is the tanh form computed in float32 and cast back,
and LayerNorm takes its statistics in float32 and casts to the input dtype
before the affine.

Under ``config.int8_mode()`` (this thread), ``linear``, ``conv1d_token``,
``conv1x1``, ``patch_embed`` and a 1×1 ``conv2d`` run their contraction
through ``quant.dynamic_int8_matmul``, as the JAX package's ``nnf._dense``
does.

``group_norm`` (NHWC) has the JAX package's hand-written backward for bf16
activations (``GroupNormAffine``); ``drop_path`` draws its per-sample masks
from an explicit ``torch.Generator``.

``run_blocks`` is the models' block loop (the JAX ``scan_blocks``), with
activation checkpointing under ``config.remat_mode()``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import config

_SQRT_HALF = 1.0 / math.sqrt(2.0)
_TANH_C = math.sqrt(2.0 / math.pi)


def gelu_erf(x):
    """Exact-erf GELU (torch nn.GELU())."""
    return 0.5 * x * (1.0 + torch.erf(x * _SQRT_HALF))


def gelu_tanh(x):
    """Hendrycks tanh-form GELU, in the dtype it is given."""
    return 0.5 * x * (1.0 + torch.tanh(_TANH_C * (x + 0.044715 * x * x * x)))


def gelu(x):
    """Exact erf for float32; for bf16 the tanh form in float32, cast back
    (|error vs exact| < 5e-4, under bf16 resolution)."""
    if x.dtype == torch.bfloat16:
        return gelu_tanh(x.float()).to(x.dtype)
    return gelu_erf(x)


def softmax(x, dim=-1):
    """Softmax over ``dim`` (``jax.nn.softmax``), in x's dtype; torch
    accumulates a bf16 input in float32 and rounds once."""
    return torch.softmax(x, dim)


def _dense(x, wt):
    """x @ wt: a plain matmul, or dynamic W8A8 int8 under int8_mode()."""
    if config.int8_enabled():
        from ..quant import dynamic_int8_matmul

        return dynamic_int8_matmul(x, wt)
    return torch.matmul(x, wt)


def linear(x, weight, bias=None):
    """torch nn.Linear: x[..., in] @ weight(out, in)^T + bias."""
    y = _dense(x, weight.t())
    if bias is not None:
        y = y + bias
    return y


def conv1d_token(x, weight, bias=None):
    """torch nn.Conv1d(N_in, N_out, kernel_size=1) applied over the token
    axis. x: (..., N_in, D); weight: (N_out, N_in, 1)."""
    w = weight[:, :, 0]
    if config.int8_enabled():
        # the contraction runs over the token axis: move it last, so the
        # per-token activation scales cover the contracted slice
        y = _dense(x.transpose(-1, -2), w.t()).transpose(-1, -2)
    else:
        y = torch.matmul(w, x)
    if bias is not None:
        y = y + bias[:, None]
    return y


def conv1x1(x, weight, bias=None):
    """torch nn.Conv2d(k=1) on channel-last x as a matmul: weight
    (O, I, 1, 1) → x[..., I] @ W^T (+ bias)."""
    y = _dense(x, weight[:, :, 0, 0].t())
    if bias is not None:
        y = y + bias
    return y


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_pads(padding, hw, kernel, stride, dilation):
    """((top, bottom), (left, right)) of ``padding``: an int, a pair, a pair
    of pairs, or "same" as XLA reads it (output ceil(n / stride), the total
    pad split with the extra one after)."""
    if padding == "same":
        pads = []
        for n, k, s, d in zip(hw, kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    ph, pw = padding
    if isinstance(ph, int):
        return ((ph, ph), (pw, pw))
    return (tuple(ph), tuple(pw))


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1, dilation=1):
    """torch nn.Conv2d on NHWC x with an OIHW weight (O, I/groups, kh, kw),
    the JAX ``nnf.conv2d``. A 1×1, groups-1, stride-1 conv with padding 0 or
    "same" is the dense product (int8 under ``int8_mode()``, as JAX sends it
    to ``_dense``); every other conv is ``F.conv2d`` (cuDNN on the card) on
    the channels-last view, and never int8."""
    stride, dilation = _pair(stride), _pair(dilation)
    if (weight.shape[2] == weight.shape[3] == 1 and groups == 1 and stride == (1, 1)
            and padding in (0, (0, 0), "same")):
        y = _dense(x, weight[:, :, 0, 0].t().to(x.dtype))
        return y if bias is None else y + bias
    (pt, pb), (pl, pr) = _conv_pads(padding, x.shape[1:3], weight.shape[2:], stride, dilation)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor: channels-last strides
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc, pad = F.pad(xc, (pl, pr, pt, pb)), 0
    y = F.conv2d(xc, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                 stride, pad, dilation, groups)
    return y.permute(0, 2, 3, 1)


def patch_embed(x, weight, bias, patch_size):
    """Non-overlapping Conv2d(k=s=patch) as reshape + one matmul.
    x NHWC → (B, H/p, W/p, O)."""
    ph, pw = (patch_size, patch_size) if isinstance(patch_size, int) else patch_size
    B, H, W, C = x.shape
    x = x.reshape(B, H // ph, ph, W // pw, pw, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # B, H/p, W/p, C, ph, pw
    x = x.reshape(B, H // ph, W // pw, C * ph * pw)
    w = weight.reshape(weight.shape[0], -1)  # (O, C*ph*pw)
    y = _dense(x, w.t().to(x.dtype))
    if bias is not None:
        y = y + bias
    return y


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """torch nn.LayerNorm over the last axis; stats in float32, the
    normalized value cast to the input dtype before the affine."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype)
        if bias is not None:
            y = y + bias.to(x.dtype)
    return y


def _group_stats(x, num_groups, eps):
    """(x̂ in float32, per-group rsqrt) of NHWC x, the statistics in float32
    over (H, W, C/g) of each group; x̂ has shape (B, H, W, g, C/g)."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H, W, num_groups, C // num_groups)
    mu = xf.mean((1, 2, 4), keepdim=True)
    var = (xf - mu).square().mean((1, 2, 4), keepdim=True)
    r = torch.rsqrt(var + eps)
    return (xf - mu) * r, r


def group_norm(x, weight=None, bias=None, num_groups=1, eps=1e-5):
    """torch nn.GroupNorm on NHWC x: statistics in float32 over (H, W, C/g)
    per group, x̂ cast to x's dtype before the affine, which runs in x's
    dtype. For bf16 x with weights this is ``GroupNormAffine``, whose
    backward is the JAX package's analytic one; float32 differentiates the
    composed form, as JAX does."""
    if weight is not None and x.dtype == torch.bfloat16:
        return GroupNormAffine.apply(x, weight, bias, num_groups, eps)
    xhat, _ = _group_stats(x, num_groups, eps)
    y = xhat.reshape(x.shape).to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype) + bias.to(x.dtype)
    return y


class GroupNormAffine(torch.autograd.Function):
    """GroupNorm with an affine on bf16 NHWC activations (the JAX
    ``_group_norm_affine`` custom VJP). It saves only x̂ (in x's dtype) and
    the per-group rsqrt r; the backward reduces in float32:
    dw = Σ dy·x̂, db = Σ dy, dx = r·(dy·w − mean(dy·w) − x̂·mean(dy·w·x̂))
    with the means over (H, W, C/g) of each group."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        xhat, r = _group_stats(x, num_groups, eps)
        xhat = xhat.reshape(x.shape).to(x.dtype)
        ctx.num_groups = num_groups
        ctx.save_for_backward(xhat, r, weight)
        ctx.bias_dtype = bias.dtype
        return xhat * weight.to(x.dtype) + bias.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, r, weight = ctx.saved_tensors
        B, H, W, C = dy.shape
        g = ctx.num_groups
        dyf = dy.float()
        xh = xhat.float()
        dw = (dyf * xh).sum((0, 1, 2))
        db = dyf.sum((0, 1, 2))
        dxh = (dyf * weight.float()).reshape(B, H, W, g, C // g)
        xh5 = xh.reshape(B, H, W, g, C // g)
        m1 = dxh.mean((1, 2, 4), keepdim=True)
        m2 = (dxh * xh5).mean((1, 2, 4), keepdim=True)
        dx = (r * (dxh - m1 - xh5 * m2)).reshape(B, H, W, C).to(dy.dtype)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None, None


def affine(x, alpha, beta):
    """ResMLP's Aff layer: x * alpha + beta, broadcast on the last axis
    (alpha, beta of shape (1, 1, C) or (C,))."""
    return x * alpha.reshape(-1) + beta.reshape(-1)


def global_avg_pool_tokens(x):
    """Mean over the token axis: (B, N, D) → (B, D)."""
    return x.mean(-2)


def _keep(rate):
    """1 - rate in float32, as the JAX package computes it."""
    return float(np.float32(1) - np.float32(rate))


def drop_path_mask(batch, rate, generator, device):
    """Per-sample keep mask (batch,) of stochastic depth at ``rate``:
    Bernoulli(1 - rate) from ``generator`` (on ``device``)."""
    return torch.rand(batch, generator=generator, device=device) < _keep(rate)


def drop_path(x, rate, train, generator=None, mask=None):
    """Stochastic depth per sample (the JAX ``nnf.drop_path``): where the
    sample's mask is set x / keep (keep in x's dtype), else 0. The mask is
    ``mask`` if given, else drawn from ``generator``. Identity in eval, at
    rate 0, or with neither. JAX's threefry and torch's Philox draw
    different masks from the same seed."""
    if not train or rate == 0 or (generator is None and mask is None):
        return x
    if mask is None:
        mask = drop_path_mask(x.shape[0], rate, generator, x.device)
    keep = torch.tensor(_keep(rate), dtype=x.dtype).item()  # rounded to x's dtype
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x / keep, 0.0)


class _BlockCall(nn.Module):
    """``fn(block, x)`` as a module, so that ``functional_call`` can bind
    the block's tensors for one call."""

    def __init__(self, block, fn):
        super().__init__()
        self.block = block
        self.fn = fn

    def forward(self, x):
        return self.fn(self.block, x)


def run_blocks(blocks, x, fn, remat=False):
    """x through every block in turn: ``x = fn(block, x)``.

    Under ``config.remat_mode()`` or with ``remat`` (a factory's
    ``use_checkpoint``), with gradients on, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant). The block's parameters and
    buffers as they are now (under a train step's ``functional_call``, its
    cast copies) go in as explicit inputs and are bound again when the
    backward recomputes the block, so the recompute reads the tensors the
    forward read."""
    for blk in blocks:
        if not ((remat or config.remat) and torch.is_grad_enabled()):
            x = fn(blk, x)
            continue
        call = _BlockCall(blk, fn)
        named = {**dict(call.named_parameters()), **dict(call.named_buffers())}

        def run(x, *tensors, call=call, names=tuple(named)):
            return torch.func.functional_call(call, dict(zip(names, tensors)), (x,))

        x = checkpoint(run, x, *named.values(), use_reentrant=False)
    return x
