"""ViP (Vision Permutator) in PyTorch (counterpart of ``jittor_mlp_tpu/models/vip.py``).

Patchify Conv2d(k=s=patch) as one matmul on NHWC activations, then
``depth`` blocks of

    h = h + proj(mix(LN(h)))          mix: H-mixing, W-mixing, channel Linear
    h = h + fc3(GELU(fc0(LN(h))))

and LN → spatial mean → Linear head. The H- and W-mixing branches permute
``segments`` channels along the mixed axis ('b h w (c s) -> b w c (h s)'),
apply a Linear(H·s) and permute back; both are one ``torch.einsum`` on the
weight reshaped to (H, s, H, s), '(h s)' h-major. With ``weighted=True``
the three branches are fused by ``split_attention`` (a softmax over the
branches of a gate built from their sum), else summed.

Under ``config.int8_mode()`` the Linear layers and the patch embedding run
as dynamic W8A8 (``nnf.linear``, ``nnf.patch_embed``); the two mixing
einsums stay in the compute dtype, as in the JAX package.

Parameter names are the torch reference's (``patcher.0``,
``blocks.model.{i}.0.norm``, ``blocks.model.{i}.0.fn.0.fns.{0,1}.1``,
``...fn.0.fns.2``, ``...fn.0.split_attention.{mlp1,mlp2}``,
``blocks.model.{i}.0.fn.1``, ``blocks.model.{i}.1.{norm,fn.0,fn.3}``,
``mlp_head.{0,2}``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..utils import pair


def _init_state_dict(seed, *, in_channels, d_model, patch_size, height, width, segments,
                     depth, expansion_factor, weighted, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    b.conv2d("patcher.0", in_channels, d_model, patch_size)
    for i in range(depth):
        pre = f"blocks.model.{i}"
        b.layer_norm(f"{pre}.0.norm", d_model)
        b.linear(f"{pre}.0.fn.0.fns.0.1", height * segments, height * segments)
        b.linear(f"{pre}.0.fn.0.fns.1.1", width * segments, width * segments)
        b.linear(f"{pre}.0.fn.0.fns.2", d_model, d_model)
        if weighted:
            b.linear(f"{pre}.0.fn.0.split_attention.mlp1", d_model, d_model, bias=False)
            b.linear(f"{pre}.0.fn.0.split_attention.mlp2", d_model, d_model * 3, bias=False)
        b.linear(f"{pre}.0.fn.1", d_model, d_model)
        b.layer_norm(f"{pre}.1.norm", d_model)
        b.linear(f"{pre}.1.fn.0", d_model, d_model * expansion_factor)
        b.linear(f"{pre}.1.fn.3", d_model * expansion_factor, d_model)
    b.layer_norm("mlp_head.0", d_model)
    b.linear("mlp_head.2", d_model, num_classes)
    return b.sd


def _linear(x, layer):
    return nnf.linear(x, layer.weight, layer.bias)


def mix_h(x, layer, s):
    """Segment-permuted H mixing: Linear(H·s) over (h, s) of x viewed as
    (B, H, W, C/s, s), the weight as (out h, out s, in h, in s)."""
    B, H, W, C = x.shape
    w4 = layer.weight.reshape(H, s, H, s)
    y = torch.einsum("bhwcs,klhs->bkwcl", x.reshape(B, H, W, C // s, s), w4)
    return (y + layer.bias.reshape(H, s)[:, None, None, :]).reshape(B, H, W, C)


def mix_w(x, layer, s):
    """The W-axis counterpart of ``mix_h``."""
    B, H, W, C = x.shape
    w4 = layer.weight.reshape(W, s, W, s)
    y = torch.einsum("bhwcs,klws->bhkcl", x.reshape(B, H, W, C // s, s), w4)
    return (y + layer.bias.reshape(W, s)[None, None, :, None, :]).reshape(B, H, W, C)


class SplitAttention(nn.Module):
    def __init__(self, dim, k=3):
        super().__init__()
        self.mlp1 = nn.Linear(dim, dim, bias=False)
        self.mlp2 = nn.Linear(dim, dim * k, bias=False)


def split_attention(sa, branches):
    """Softmax-over-branches channel gating: the gate's input is the sum of
    the k branches summed over H and W, ``mlp2(GELU(mlp1(·)))`` gives k
    logits a channel, and the output is the softmax-weighted sum of the
    branches. ``sa`` holds ``mlp1`` and ``mlp2`` (bias-free Linears)."""
    B, _, _, C = branches[0].shape
    k = len(branches)
    a = sum(branches).sum((1, 2))  # (B, C)
    hat = nnf.linear(nnf.gelu(nnf.linear(a, sa.mlp1.weight)), sa.mlp2.weight)
    bar = nnf.softmax(hat.reshape(B, k, C), dim=1)
    return sum(bar[:, i, None, None, :] * b for i, b in enumerate(branches))


class WeightedPermuteMLP(nn.Module):
    """fns.0 / fns.1: the H- and W-mixing Linears (index 0 is the
    reference's parameter-free Rearrange); fns.2: the channel Linear."""

    def __init__(self, dim, height, width, segments, weighted):
        super().__init__()
        self.fns = nn.ModuleList([
            nn.Sequential(nn.Identity(), nn.Linear(height * segments, height * segments)),
            nn.Sequential(nn.Identity(), nn.Linear(width * segments, width * segments)),
            nn.Linear(dim, dim),
        ])
        self.split_attention = SplitAttention(dim) if weighted else None


class PreNormResidual(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


class ViPModel(Model):
    name = "vip"

    def __init__(self, *, image_size, patch_size, in_channels, num_classes, d_model, depth,
                 segments, expansion_factor, weighted, seed):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if d_model % segments:
            raise ValueError("d_model must be divisible by segments")
        height, width = ih // ph, iw // pw
        self.patch_size = (ph, pw)
        self.segments = segments
        self.weighted = weighted
        hidden = d_model * expansion_factor
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patcher = nn.Sequential(nn.Conv2d(in_channels, d_model, (ph, pw),
                                                   stride=(ph, pw)))
            self.blocks = nn.Module()
            self.blocks.model = nn.ModuleList(
                nn.Sequential(
                    PreNormResidual(d_model, nn.Sequential(
                        WeightedPermuteMLP(d_model, height, width, segments, weighted),
                        nn.Linear(d_model, d_model))),
                    PreNormResidual(d_model, nn.Sequential(
                        nn.Linear(d_model, hidden), nn.GELU(), nn.Dropout(0.0),
                        nn.Linear(hidden, d_model), nn.Dropout(0.0))),
                )
                for _ in range(depth))
            self.mlp_head = nn.Sequential(nn.LayerNorm(d_model), nn.Identity(),
                                          nn.Linear(d_model, num_classes))
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, d_model=d_model, patch_size=(ph, pw),
            height=height, width=width, segments=segments, depth=depth,
            expansion_factor=expansion_factor, weighted=weighted, num_classes=num_classes,
        ))

    def block(self, blk, h):
        t, c = blk[0], blk[1]
        perm = t.fn[0]
        y = nnf.layer_norm(h, t.norm.weight, t.norm.bias)
        b1 = mix_h(y, perm.fns[0][1], self.segments)
        b2 = mix_w(y, perm.fns[1][1], self.segments)
        b3 = _linear(y, perm.fns[2])
        y = split_attention(perm.split_attention, [b1, b2, b3]) if self.weighted \
            else b1 + b2 + b3
        h = h + _linear(y, t.fn[1])
        y = nnf.layer_norm(h, c.norm.weight, c.norm.bias)
        return h + _linear(nnf.gelu(_linear(y, c.fn[0])), c.fn[3])

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        conv = self.patcher[0]
        x = nnf.patch_embed(x, conv.weight, conv.bias, self.patch_size)
        x = nnf.run_blocks(self.blocks.model, x, self.block, runner=self.block_runner)
        norm, head = self.mlp_head[0], self.mlp_head[2]
        x = nnf.layer_norm(x, norm.weight, norm.bias).mean((1, 2))
        return _linear(x, head)


def ViP(
    image_size=224,
    patch_size=16,
    in_channels=3,
    num_classes=1000,
    d_model=256,
    depth=30,
    segments=14,
    expansion_factor=4,
    weighted=True,
    block_runner=None,
    seed=0,
    device="cuda",
):
    """ViP; the JAX factory's signature, plus device (where the model is
    built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises). block_runner: optional fn(fn, blocks, x) running the
    block stack (``parallel.pipeline_runner``)."""
    return ViPModel(
        image_size=image_size, patch_size=patch_size, in_channels=in_channels,
        num_classes=num_classes, d_model=d_model, depth=depth, segments=segments,
        expansion_factor=expansion_factor, weighted=weighted, seed=seed,
    ).place(device).with_runner(block_runner)
