"""DynaMixer in PyTorch (counterpart of ``jittor_mlp_tpu/models/dyna_mlp.py``).

Two stages of a patchify Conv2d(k=s=patch) as one matmul on NHWC
activations and blocks of

    y = LN(h);  h = h + drop_path(proj_o(op_h(y) + op_w(y) + proj_c(y)))
    h = h + drop_path(fc3(GELU(fc0(LN(h)))))

then a spatial mean and a Linear head. A DynaMixer operation mixes the
tokens along one axis with content-dependent weights: the channels split
into ``segment`` groups ('(s d)', s-major); per segment a Linear ``Wd.{s}``
(C → hidden) projects every token; the L tokens' projections of a segment,
flattened to hidden·L, go through ``attend`` (hidden·L → L²), a softmax
over the last axis gives an L × L mixing matrix, which multiplies the
segment's tokens; ``proc`` projects the result. The H-axis operation is
the W-axis one on swapped axes.

The per-segment projections run as one product with the ``Wd.{s}``
weights stacked (seg, hidden, C), and the mixing matrices are applied as
one batched product in every dtype and at every batch (the JAX package's
VPU unroll of that product is a TPU lowering and is not ported). Under
``config.int8_mode()`` the Linear layers (``proj_c``, ``proj_o``,
``attend``, ``proc``, the FF) and the patch embedding run as dynamic
W8A8; the ``Wd`` projection and the mixing product stay in the compute
dtype, as in the JAX package. In training with a generator both residual
branches of every block take drop-path at the setting's rate, as in JAX.

``dynamlp_settings`` holds the T, M and L configurations as (patch sizes,
dims, depths, segments, mlp ratio, drop-path rate, hidden); a caller may
add one.

Parameter names are the torch reference's (``stages.{s}.0``,
``stages.{s}.1.layers.{j}.0.{norm,fn.proj_c,fn.proj_o}``,
``...0.fn.DynaMixerOp_{h,w}.{Wd.{k},attend.1,proc}``,
``...1.{norm,fn.net.0,fn.net.3}``, ``mlp_head.1``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model

dynamlp_settings = {
    "T": [[7, 2], [192, 384], [4, 14], [8, 16], 3, 0.1, 2],
    "M": [[7, 2], [256, 512], [7, 17], [8, 16], 3, 0.1, 2],
    "L": [[7, 2], [256, 512], [9, 27], [8, 16], 3, 0.3, 8],
}


def _init_state_dict(seed, *, in_channels, patch_size, embed_dims, depths, segment,
                     mlp_ratio, hidden, res, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    for si, d in enumerate(embed_dims):
        cin = in_channels if si == 0 else embed_dims[si - 1]
        b.conv2d(f"stages.{si}.0", cin, d, patch_size[si])
        for j in range(depths[si]):
            pre = f"stages.{si}.1.layers.{j}"
            b.layer_norm(f"{pre}.0.norm", d)
            b.linear(f"{pre}.0.fn.proj_c", d, d)
            b.linear(f"{pre}.0.fn.proj_o", d, d)
            for op in ("DynaMixerOp_h", "DynaMixerOp_w"):
                for s in range(segment[si]):
                    b.linear(f"{pre}.0.fn.{op}.Wd.{s}", d, hidden)
                b.linear(f"{pre}.0.fn.{op}.attend.1", hidden * res[si], res[si] ** 2)
                b.linear(f"{pre}.0.fn.{op}.proc", d, d)
            b.layer_norm(f"{pre}.1.norm", d)
            b.linear(f"{pre}.1.fn.net.0", d, d * mlp_ratio)
            b.linear(f"{pre}.1.fn.net.3", d * mlp_ratio, d)
    b.linear("mlp_head.1", embed_dims[-1], num_classes)
    return b.sd


def _linear(x, layer):
    return nnf.linear(x, layer.weight, layer.bias)


class DynaMixerOp(nn.Module):
    def __init__(self, dim, length, segment, hidden):
        super().__init__()
        self.segment, self.hidden = segment, hidden
        self.Wd = nn.ModuleList(nn.Linear(dim, hidden) for _ in range(segment))
        self.attend = nn.Sequential(nn.Identity(), nn.Linear(hidden * length, length * length))
        self.proc = nn.Linear(dim, dim)

    def forward(self, x, axis):
        """Mix x (B, H, W, C) along ``axis`` (2: W, 1: H)."""
        if axis == 1:
            x = x.transpose(1, 2)
        B, H, W, C = x.shape
        seg, hidden = self.segment, self.hidden
        wd = torch.cat([lin.weight for lin in self.Wd])  # (seg·hidden, C), s-major
        bd = torch.cat([lin.bias for lin in self.Wd])
        # per-segment projections, laid out (b, h, s, w, o) for the attend input
        p = (torch.matmul(x, wd.t()) + bd).reshape(B, H, W, seg, hidden).transpose(2, 3)
        attn = _linear(p.reshape(B, H, seg, W * hidden), self.attend[1])
        attn = nnf.softmax(attn.reshape(B, H, seg, W, W), dim=-1)
        xs = x.reshape(B, H, W, seg, C // seg).transpose(2, 3)  # (b, h, s, w, d)
        y = torch.matmul(attn, xs).transpose(2, 3).reshape(B, H, W, C)
        y = _linear(y, self.proc)
        return y.transpose(1, 2) if axis == 1 else y


class DynaMixerBlock(nn.Module):
    def __init__(self, dim, length, segment, hidden):
        super().__init__()
        self.proj_c = nn.Linear(dim, dim)
        self.proj_o = nn.Linear(dim, dim)
        self.DynaMixerOp_h = DynaMixerOp(dim, length, segment, hidden)
        self.DynaMixerOp_w = DynaMixerOp(dim, length, segment, hidden)


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


class FeedForward(nn.Module):
    """net.0 and net.3 are the Linears; 1 is the GELU, 2 and 4 dropouts."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
                                 nn.Linear(hidden, dim), nn.Identity())


class Layer(nn.Sequential):
    """One block: the mixer (0) and the feed-forward (1), each a residual
    branch with drop-path at ``drop_path_rate``."""

    drop_paths = 2  # Model.drop_path_masks: one mask per residual branch

    def __init__(self, dim, length, segment, hidden, mlp_ratio, drop_path_rate):
        super().__init__(PreNorm(dim, DynaMixerBlock(dim, length, segment, hidden)),
                         PreNorm(dim, FeedForward(dim, dim * mlp_ratio)))
        self.drop_path_rate = drop_path_rate  # a float, not a parameter


class Stage(nn.Module):
    def __init__(self, dim, depth, length, segment, hidden, mlp_ratio, drop_path_rate):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(dim, length, segment, hidden, mlp_ratio, drop_path_rate)
            for _ in range(depth))


def dyna_block(blk, h, masks=None):
    """One ``Layer`` on h; masks: its two drop-path masks, or None."""
    m1, m2 = masks or (None, None)
    train, rate = masks is not None, blk.drop_path_rate
    t, c = blk[0], blk[1]
    y = nnf.layer_norm(h, t.norm.weight, t.norm.bias)
    fn = t.fn
    y = fn.DynaMixerOp_h(y, 1) + fn.DynaMixerOp_w(y, 2) + _linear(y, fn.proj_c)
    h = h + nnf.drop_path(_linear(y, fn.proj_o), rate, train, mask=m1)
    y = nnf.layer_norm(h, c.norm.weight, c.norm.bias)
    net = c.fn.net
    return h + nnf.drop_path(_linear(nnf.gelu(_linear(y, net[0])), net[3]), rate, train,
                             mask=m2)


class DynaMixerModel(Model):
    name = "dyna_mlp"
    stochastic = True  # drop-path: the train forward takes a generator

    def __init__(self, *, model_name, image_size, in_channels, num_classes, seed):
        super().__init__()
        if model_name not in dynamlp_settings:
            raise ValueError(f"model_name {model_name!r} not in {sorted(dynamlp_settings)}")
        patch_size, embed_dims, depths, segment, mlp_ratio, drop_path, hidden = (
            dynamlp_settings[model_name])
        res, cur = [], image_size
        for ps in patch_size:
            cur //= ps
            res.append(cur)
        self.patch_sizes = list(patch_size)
        with torch.device("meta"):  # weights come from SDBuilder below
            self.stages = nn.ModuleList(
                nn.Sequential(
                    nn.Conv2d(in_channels if si == 0 else embed_dims[si - 1], d,
                              patch_size[si], stride=patch_size[si]),
                    Stage(d, depths[si], res[si], segment[si], hidden, mlp_ratio, drop_path))
                for si, d in enumerate(embed_dims))
            self.mlp_head = nn.Sequential(nn.Identity(), nn.Linear(embed_dims[-1], num_classes))
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, patch_size=patch_size, embed_dims=embed_dims,
            depths=depths, segment=segment, mlp_ratio=mlp_ratio, hidden=hidden, res=res,
            num_classes=num_classes))

    def forward(self, x, generator=None):
        """x: (B, C, H, W) → logits (B, num_classes). ``generator``: the
        drop-path random source in training."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        masks = self.drop_path_masks(x, generator)
        for stage, patch in zip(self.stages, self.patch_sizes):
            conv = stage[0]
            x = nnf.patch_embed(x, conv.weight, conv.bias, patch)
            x = nnf.run_blocks(stage[1].layers, x,
                               lambda blk, h: dyna_block(blk, h, masks.get(blk)))
        return _linear(x.mean((1, 2)), self.mlp_head[1])


def DynaMixer(model_name="M", image_size=224, in_channels=3, num_classes=1000, seed=0,
              device="cuda"):
    """DynaMixer; the JAX factory's signature, plus device (where the model
    is built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises)."""
    return DynaMixerModel(model_name=model_name, image_size=image_size,
                          in_channels=in_channels, num_classes=num_classes,
                          seed=seed).place(device)
