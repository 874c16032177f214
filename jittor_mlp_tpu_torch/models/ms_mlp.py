"""MS-MLP (Mix-Shift MLP) in PyTorch (counterpart of
``jittor_mlp_tpu/models/ms_mlp.py``).

A Swin-style hierarchy on NHWC activations: patch embedding (Conv2d
k=s=patch as one matmul) and LayerNorm (eps 1e-6), then stages of blocks

    y = Σ_k dwconv_lr.k(roll_W(h_k)) ⧺ Σ_k dwconv_td.k(roll_H(h_k))
    h = h + gamma · pwconv2(GELU(pwconv1(LN(y))))

where h_k is the k-th of ``shift_size`` channel chunks (sized as
``torch.chunk`` sizes them: ceil, the last possibly smaller), rolled **with
wrap-around** by ``shift_dist[k]`` along W (lr) and along H (td), each
through a depthwise conv of kernel ``mix_size[stage][k]`` with padding
ks//2; the chunks' outputs are concatenated and the two paths summed.
Between stages a patch embedding of patch 2 and its LayerNorm; at the end a
spatial mean, LayerNorm and the head.

The depthwise convs are ``nnf.conv2d`` (``F.conv2d``; a 1×1 one too, since
its groups are not 1) and stay out of int8; ``pwconv1``/``pwconv2``, the
patch embeddings and the head run as dynamic W8A8 under
``config.int8_mode()``, as in the JAX package. Drop-path (training) is not
ported: the train-mode forward applies none.

Parameter names are the torch reference's (``patch_embed.{proj,norm}``,
``layers.{i}.blocks.{j}.{dwconv_lr.{k},dwconv_td.{k},norm,pwconv1,pwconv2,
gamma}``, ``layers.{i}.downsample.{proj,norm}``, ``norm``, ``head``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..utils import pair


def _chunk_sizes(dim, n):
    """torch.chunk sizing: ceil-sized chunks, the last possibly smaller."""
    size = math.ceil(dim / n)
    return [min(size, dim - c) for c in range(0, dim, size)]


def _init_state_dict(seed, *, in_chans, embed_dim, depths, shift_size, mix_size, mlp_ratio,
                     patch_norm, patch_size, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    n_layers = len(depths)
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", in_chans, embed_dim, patch_size)
    if patch_norm:
        b.layer_norm("patch_embed.norm", embed_dim)
    for i in range(n_layers):
        dim = int(embed_dim * 2 ** i)
        for j in range(depths[i]):
            pre = f"layers.{i}.blocks.{j}"
            for k, cs in enumerate(_chunk_sizes(dim, shift_size)):
                b.conv2d(f"{pre}.dwconv_lr.{k}", cs, cs, mix_size[i][k], groups=cs)
                b.conv2d(f"{pre}.dwconv_td.{k}", cs, cs, mix_size[i][k], groups=cs)
            b.layer_norm(f"{pre}.norm", dim)
            b.linear(f"{pre}.pwconv1", dim, int(mlp_ratio * dim))
            b.linear(f"{pre}.pwconv2", int(mlp_ratio * dim), dim)
            b.const(f"{pre}.gamma", (dim,), 1e-6)
        if i < n_layers - 1:
            b.conv2d(f"layers.{i}.downsample.proj", dim, 2 * dim, 2)
            b.layer_norm(f"layers.{i}.downsample.norm", 2 * dim)
    num_features = int(embed_dim * 2 ** (n_layers - 1))
    b.layer_norm("norm", num_features)
    b.linear("head", num_features, num_classes)
    return b.sd


class MixShiftBlock(nn.Module):
    def __init__(self, dim, shift_size, shift_dist, mix_size, mlp_ratio):
        super().__init__()
        self.chunks = _chunk_sizes(dim, shift_size)
        self.shift_dist = list(shift_dist)
        self.mix_size = list(mix_size)
        self.dwconv_lr = nn.ModuleList(nn.Conv2d(cs, cs, mix_size[k], groups=cs)
                                       for k, cs in enumerate(self.chunks))
        self.dwconv_td = nn.ModuleList(nn.Conv2d(cs, cs, mix_size[k], groups=cs)
                                       for k, cs in enumerate(self.chunks))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, int(mlp_ratio * dim))
        self.pwconv2 = nn.Linear(int(mlp_ratio * dim), dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, h):
        lr, td = [], []
        for k, xc in enumerate(torch.split(h, self.chunks, dim=-1)):
            d, pad = self.shift_dist[k], self.mix_size[k] // 2
            for convs, axis, out in ((self.dwconv_lr, 2, lr), (self.dwconv_td, 1, td)):
                conv = convs[k]
                out.append(nnf.conv2d(torch.roll(xc, d, axis), conv.weight, conv.bias,
                                      padding=pad, groups=conv.groups))
        y = torch.cat(lr, -1) + torch.cat(td, -1)
        y = nnf.layer_norm(y, self.norm.weight, self.norm.bias, eps=1e-6)
        y = nnf.gelu(nnf.linear(y, self.pwconv1.weight, self.pwconv1.bias))
        y = nnf.linear(y, self.pwconv2.weight, self.pwconv2.bias)
        return h + self.gamma * y


class PatchEmbed(nn.Module):
    def __init__(self, in_chans, embed_dim, patch_size, norm):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6) if norm else None

    def forward(self, x, patch_size):
        x = nnf.patch_embed(x, self.proj.weight, self.proj.bias, patch_size)
        if self.norm is None:
            return x
        return nnf.layer_norm(x, self.norm.weight, self.norm.bias, eps=1e-6)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, shift_size, shift_dist, mix_size, mlp_ratio, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            MixShiftBlock(dim, shift_size, shift_dist, mix_size, mlp_ratio)
            for _ in range(depth))
        self.downsample = PatchEmbed(dim, 2 * dim, 2, True) if downsample else None


class MSMLP(Model):
    name = "ms_mlp"

    def __init__(self, *, img_size, patch_size, in_chans, num_classes, embed_dim, depths,
                 shift_size, shift_dist, mix_size, mlp_ratio, patch_norm, use_checkpoint,
                 seed):
        super().__init__()
        del img_size  # the patch embedding follows the input, as in JAX
        n_layers = len(depths)
        self.patch_size = pair(patch_size)
        self.use_checkpoint = use_checkpoint
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = PatchEmbed(in_chans, embed_dim, self.patch_size, patch_norm)
            self.layers = nn.ModuleList(
                BasicLayer(int(embed_dim * 2 ** i), depths[i], shift_size, shift_dist,
                           mix_size[i], mlp_ratio, i < n_layers - 1)
                for i in range(n_layers))
            num_features = int(embed_dim * 2 ** (n_layers - 1))
            self.norm = nn.LayerNorm(num_features, eps=1e-6)
            self.head = nn.Linear(num_features, num_classes)
        self._load_init(_init_state_dict(
            seed, in_chans=in_chans, embed_dim=embed_dim, depths=depths,
            shift_size=shift_size, mix_size=mix_size, mlp_ratio=mlp_ratio,
            patch_norm=patch_norm, patch_size=self.patch_size, num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = self.patch_embed(x.permute(0, 2, 3, 1), self.patch_size)  # NCHW → NHWC
        for layer in self.layers:
            x = nnf.run_blocks(layer.blocks, x, lambda blk, h: blk(h),
                               remat=self.use_checkpoint)
            if layer.downsample is not None:
                x = layer.downsample(x, 2)
        x = nnf.layer_norm(x.mean((1, 2)), self.norm.weight, self.norm.bias, eps=1e-6)
        return nnf.linear(x, self.head.weight, self.head.bias)


def MS_MLP(
    img_size=224,
    patch_size=4,
    in_chans=3,
    num_classes=1000,
    embed_dim=96,
    depths=[2, 2, 6, 2],
    shift_size=5,
    shift_dist=[-2, -1, 0, 1, 2],
    mix_size=[[1, 1, 3, 5, 7], [1, 1, 3, 5, 5], [1, 1, 3, 3, 3], [1, 1, 1, 1, 3]],
    mlp_ratio=4.0,
    drop_rate=0.0,
    drop_path_rate=0.1,
    patch_norm=True,
    use_checkpoint=False,
    seed=0,
    device="cuda",
    **kwargs,
):
    """MS-MLP; the defaults are MS-MLP-T @224. The JAX factory's signature,
    plus device (where the model is built, the card unless the caller asks
    for the CPU; with no card, "cuda" raises). drop_rate is accepted and
    unused and other keyword arguments are ignored, as in JAX;
    drop_path_rate has no effect in eval, and training is not ported yet.
    use_checkpoint checkpoints every block."""
    del drop_rate, drop_path_rate, kwargs  # see the docstring
    return MSMLP(
        img_size=img_size, patch_size=patch_size, in_chans=in_chans, num_classes=num_classes,
        embed_dim=embed_dim, depths=list(depths), shift_size=shift_size,
        shift_dist=list(shift_dist), mix_size=[list(m) for m in mix_size],
        mlp_ratio=mlp_ratio, patch_norm=patch_norm, use_checkpoint=use_checkpoint, seed=seed,
    ).place(device)
