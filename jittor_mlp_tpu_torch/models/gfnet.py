"""GFNet and GFNetPyramid in PyTorch (counterpart of ``jittor_mlp_tpu/models/gfnet.py``).

A block wraps one residual around the global filter and the MLP:

    x = x + γ · fc2(GELU(fc1(LN2(filter(LN1(x))))))      (LN eps 1e-6)

with γ, the layer scale, only in GFNetPyramid (unless ``no_layerscale``).
The global filter takes the tokens of an a × b grid to the frequency
domain, ``rfft2`` over the grid (norm "ortho"), multiplies them by the
learned complex weight (a, b//2 + 1, C, 2: real and imaginary parts) and
goes back with ``irfft2(s=(a, b))``; the size is passed always, so an odd
grid keeps its last column. cuFFT (on the card) and torch's CPU FFT take
no bf16, so the filter runs in float32 in every dtype: x and the weight
are cast up, transformed, multiplied and transformed back, and the result
is cast to x's dtype. The JAX package's per-axis DFT products are a TPU
lowering and are not ported.

GFNet is flat: a patchify Conv2d(k=s=patch) as one matmul, a learned
position embedding added after it, ``depth`` blocks on one grid, LN, a
mean over the tokens, an optional ``pre_logits`` (Linear, tanh) when
``representation_size`` is set, and the head. GFNetPyramid has four
stages on grids of 56, 28, 14 and 7 tokens a side at 224 (``sizes``: the
JAX package's integer arithmetic, 56·img//224 …): a patch-``patch_size``
embedding with the position embedding before stage 0 and a patch-2 one
before each other stage. The 2 × 2 downsample needs an even grid before
it, so an image size whose first three grids are not even raises
ValueError (the JAX forward fails on its reshape there).

Under ``config.int8_mode()`` the patch embeddings, the MLPs, pre_logits
and the head run as dynamic W8A8; the filter never does. ``drop_rate``,
``dropcls``, ``drop_path_rate``, ``uniform_drop`` and ``norm_layer`` are
accepted and unused: the port's forward is the eval forward.

Parameter names are the torch reference's (``patch_embed.proj`` or
``patch_embed.{i}.proj``, ``pos_embed``, ``blocks.{i}`` or
``blocks.{s}.{j}`` with ``{norm1,filter.complex_weight,norm2,mlp.fc1,
mlp.fc2[,gamma]}``, ``norm``, ``pre_logits.fc``, ``head``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..utils import pair


def global_filter(x, complex_weight, a, b):
    """x (B, a·b, C) through the global filter of ``complex_weight``
    (a, b//2 + 1, C, 2), in float32; returns x's shape and dtype."""
    B, N, C = x.shape
    xf = torch.fft.rfft2(x.reshape(B, a, b, C).float(), dim=(1, 2), norm="ortho")
    xf = xf * torch.view_as_complex(complex_weight.float().contiguous())
    y = torch.fft.irfft2(xf, s=(a, b), dim=(1, 2), norm="ortho")
    return y.reshape(B, N, C).to(x.dtype)


class GlobalFilter(nn.Module):
    def __init__(self, dim, h, w):
        super().__init__()
        self.complex_weight = nn.Parameter(torch.empty(h, w, dim, 2))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim, mlp_ratio, h, layer_scale):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.filter = GlobalFilter(dim, h, h // 2 + 1)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layer_scale:
            self.gamma = nn.Parameter(torch.empty(dim))


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)


def gf_block(grid):
    """The block function of one grid side (``nnf.run_blocks``)."""
    def block(blk, x):
        y = nnf.layer_norm(x, blk.norm1.weight, blk.norm1.bias, eps=1e-6)
        y = global_filter(y, blk.filter.complex_weight, grid, grid)
        y = nnf.layer_norm(y, blk.norm2.weight, blk.norm2.bias, eps=1e-6)
        y = nnf.gelu(nnf.linear(y, blk.mlp.fc1.weight, blk.mlp.fc1.bias))
        y = nnf.linear(y, blk.mlp.fc2.weight, blk.mlp.fc2.bias)
        if hasattr(blk, "gamma"):
            y = blk.gamma * y
        return x + y
    return block


def _add_block(b, pre, dim, h, mlp_ratio, gamma=None):
    """One block's SDBuilder calls, in the JAX factory's order."""
    b.layer_norm(f"{pre}.norm1", dim)
    b.param(f"{pre}.filter.complex_weight",
            b.rng.standard_normal((h, h // 2 + 1, dim, 2)).astype("float32") * 0.02)
    b.layer_norm(f"{pre}.norm2", dim)
    b.linear(f"{pre}.mlp.fc1", dim, int(dim * mlp_ratio))
    b.linear(f"{pre}.mlp.fc2", int(dim * mlp_ratio), dim)
    if gamma is not None:
        b.const(f"{pre}.gamma", (dim,), gamma)


class GFNetModel(Model):
    name = "gfnet"

    def __init__(self, *, img_size, patch_size, in_chans, num_classes, embed_dim, depth,
                 mlp_ratio, representation_size, seed):
        super().__init__()
        img_size, patch_size = pair(img_size), pair(patch_size)
        self.grid = img_size[0] // patch_size[0]
        self.patch_size = patch_size
        num_patches = self.grid * (img_size[1] // patch_size[1])
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
            self.pos_embed = nn.Parameter(torch.empty(1, num_patches, embed_dim))
            self.blocks = nn.ModuleList(Block(embed_dim, mlp_ratio, self.grid, False)
                                        for _ in range(depth))
            self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
            if representation_size:
                self.pre_logits = nn.Sequential(OrderedDict(
                    fc=nn.Linear(embed_dim, representation_size), act=nn.Tanh()))
            self.head = nn.Linear(representation_size or embed_dim, num_classes)
        b = SDBuilder(seed)
        b.conv2d("patch_embed.proj", in_chans, embed_dim, patch_size)
        b.trunc_normal_("pos_embed", (1, num_patches, embed_dim), std=0.02)
        for i in range(depth):
            _add_block(b, f"blocks.{i}", embed_dim, self.grid, mlp_ratio)
        b.layer_norm("norm", embed_dim)
        if representation_size:
            b.linear("pre_logits.fc", embed_dim, representation_size)
        b.linear("head", representation_size or embed_dim, num_classes)
        self._load_init(b.sd)

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        proj = self.patch_embed.proj
        x = nnf.patch_embed(x.permute(0, 2, 3, 1), proj.weight, proj.bias, self.patch_size)
        x = x.reshape(x.shape[0], -1, x.shape[-1]) + self.pos_embed
        x = nnf.run_blocks(self.blocks, x, gf_block(self.grid))
        x = nnf.layer_norm(x, self.norm.weight, self.norm.bias, eps=1e-6).mean(1)
        if hasattr(self, "pre_logits"):
            fc = self.pre_logits.fc
            x = torch.tanh(nnf.linear(x, fc.weight, fc.bias))
        return nnf.linear(x, self.head.weight, self.head.bias)


def pyramid_sizes(img_size):
    """The grid side of each stage (JAX ``gfnet.py:216``)."""
    return [56 * img_size // 224, 28 * img_size // 224, 14 * img_size // 224,
            7 * img_size // 224]


class GFNetPyramidModel(Model):
    name = "gfnet_pyramid"

    def __init__(self, *, img_size, patch_size, num_classes, embed_dim, depth, mlp_ratio,
                 init_values, no_layerscale, seed):
        super().__init__()
        sizes = pyramid_sizes(img_size)
        if any(s % 2 or s // 2 != t for s, t in zip(sizes, sizes[1:])):
            raise ValueError(f"GFNetPyramid at img_size {img_size}: stage grids {sizes}; each "
                             f"2x2 downsample needs an even grid of twice the next")
        self.sizes, self.patch_size = sizes, patch_size
        gamma = None if no_layerscale else init_values
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = nn.ModuleList(
                [PatchEmbed(3, embed_dim[0], patch_size)]
                + [PatchEmbed(embed_dim[i], embed_dim[i + 1], 2) for i in range(3)])
            self.pos_embed = nn.Parameter(torch.empty(1, sizes[0] ** 2, embed_dim[0]))
            self.blocks = nn.ModuleList(
                nn.ModuleList(Block(embed_dim[i], mlp_ratio[i], sizes[i], gamma is not None)
                              for _ in range(depth[i]))
                for i in range(4))
            self.norm = nn.LayerNorm(embed_dim[-1], eps=1e-6)
            self.head = nn.Linear(embed_dim[-1], num_classes)
        b = SDBuilder(seed)
        b.conv2d("patch_embed.0.proj", 3, embed_dim[0], patch_size)
        for i in range(3):
            b.conv2d(f"patch_embed.{i + 1}.proj", embed_dim[i], embed_dim[i + 1], 2)
        b.trunc_normal_("pos_embed", (1, sizes[0] ** 2, embed_dim[0]), std=0.02)
        for i in range(4):
            for j in range(depth[i]):
                _add_block(b, f"blocks.{i}.{j}", embed_dim[i], sizes[i], mlp_ratio[i], gamma)
        b.layer_norm("norm", embed_dim[-1])
        b.linear("head", embed_dim[-1], num_classes)
        self._load_init(b.sd)

    def forward(self, x):
        """x: (B, 3, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        B = x.shape[0]
        for i, (embed, blocks, s) in enumerate(zip(self.patch_embed, self.blocks, self.sizes)):
            if i:
                x = x.reshape(B, self.sizes[i - 1], self.sizes[i - 1], -1)
            x = nnf.patch_embed(x, embed.proj.weight, embed.proj.bias,
                                2 if i else self.patch_size)
            x = x.reshape(B, s * s, -1)
            if i == 0:
                x = x + self.pos_embed
            x = nnf.run_blocks(blocks, x, gf_block(s))
        x = nnf.layer_norm(x, self.norm.weight, self.norm.bias, eps=1e-6).mean(1)
        return nnf.linear(x, self.head.weight, self.head.bias)


def GFNet(img_size=224, patch_size=16, in_chans=3, num_classes=1000, embed_dim=768, depth=12,
          mlp_ratio=4.0, representation_size=None, uniform_drop=False, drop_rate=0.0,
          drop_path_rate=0.0, norm_layer=None, dropcls=0, seed=0, device="cuda"):
    """GFNet; the JAX factory's signature, plus device (where the model is
    built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises). The dropout and drop-path arguments are accepted and
    unused."""
    return GFNetModel(img_size=img_size, patch_size=patch_size, in_chans=in_chans,
                      num_classes=num_classes, embed_dim=embed_dim, depth=depth,
                      mlp_ratio=mlp_ratio, representation_size=representation_size,
                      seed=seed).place(device)


def GFNetPyramid(img_size=224, patch_size=4, num_classes=1000, embed_dim=(64, 128, 256, 512),
                 depth=(2, 2, 10, 4), mlp_ratio=(4, 4, 4, 4), drop_rate=0.0,
                 drop_path_rate=0.0, norm_layer=None, init_values=0.001, no_layerscale=False,
                 dropcls=0, seed=0, device="cuda"):
    """GFNetPyramid; the JAX factory's signature, plus device. The dropout
    and drop-path arguments are accepted and unused."""
    return GFNetPyramidModel(img_size=img_size, patch_size=patch_size, num_classes=num_classes,
                             embed_dim=list(embed_dim), depth=list(depth),
                             mlp_ratio=list(mlp_ratio), init_values=init_values,
                             no_layerscale=no_layerscale, seed=seed).place(device)
