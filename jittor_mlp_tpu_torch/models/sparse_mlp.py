"""SparseMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/sparse_mlp.py``).

On NHWC activations: a non-overlapping patch embedding (optionally
LayerNorm), stages of blocks

    h = h + dwconv3x3(BN(h))
    h = h + fuse(cat[proj_h(y) along H, proj_w(y) along W, y]),  y = BN(h)
    h = h + fn.3(GELU(fn.0(LN(h))))

with a Swin PatchMerging (2×2 interleave, LayerNorm, bias-free Linear)
between stages, and at the end LayerNorm, a spatial mean and the head.

The sMLP fuse is one 1×1 product over the 3·C-channel concat, the
reference's form, at every width. (The JAX package sums three C → C
products instead where C ≥ 192, a TPU lowering: the same f32 result, but
under ``int8_mode()`` its activations get one scale per source where the
port's get one over the concat.) The H and W projections, the fuse, the
FF layers, the merge and the head run as dynamic W8A8 under
``config.int8_mode()``; the depthwise convs are ``F.conv2d``.

Parameter names are the torch reference's (``patcher.0``, ``patcher.1.1``
with ``patcher_norm``, ``layers.{s}.model.{j}.{0,1,3}.{norm,fn...}``,
``layers.{s}.patch_merge.1.{norm,reduction}``, ``mlp_head.{1,3}``). The
last stage's ``patch_merge`` is in the reference's state dict but unused
by its forward (and absent from the JAX params): the port holds it and
never runs it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..utils import pair


def _init_state_dict(seed, *, image_size, patch_size, in_channels, num_classes, d_model,
                     depth, expansion_factor, patcher_norm):
    """The JAX factory's SDBuilder calls, in its order."""
    dims = [d_model * 2 ** i for i in range(len(depth))]
    b = SDBuilder(seed)
    b.conv2d("patcher.0", in_channels, d_model, patch_size)
    if patcher_norm:
        b.layer_norm("patcher.1.1", d_model)
    for si, d in enumerate(dims):
        for j in range(depth[si]):
            pre = f"layers.{si}.model.{j}"
            b.batch_norm(f"{pre}.0.norm", d)
            b.conv2d(f"{pre}.0.fn.0", d, d, 3, groups=d)
            b.batch_norm(f"{pre}.1.norm", d)
            h_res = image_size[0] // patch_size[0] // (2 ** si)
            w_res = image_size[1] // patch_size[1] // (2 ** si)
            b.linear(f"{pre}.1.fn.0.proj_h", h_res, h_res)
            b.linear(f"{pre}.1.fn.0.proj_w", w_res, w_res)
            b.conv2d(f"{pre}.1.fn.0.fuse", 3 * d, d, 1)
            b.layer_norm(f"{pre}.3.norm", d)
            b.linear(f"{pre}.3.fn.0", d, d * expansion_factor)
            b.linear(f"{pre}.3.fn.3", d * expansion_factor, d)
        b.layer_norm(f"layers.{si}.patch_merge.1.norm", 4 * d)
        b.linear(f"layers.{si}.patch_merge.1.reduction", 4 * d, 2 * d, bias=False)
    b.layer_norm("mlp_head.1", dims[-1])
    b.linear("mlp_head.3", dims[-1], num_classes)
    return b.sd


class PreNorm(nn.Module):
    def __init__(self, norm, *fn):
        super().__init__()
        self.norm = norm
        self.fn = nn.Sequential(*fn)


class SMLPBlock(nn.Module):
    def __init__(self, h, w, dim):
        super().__init__()
        self.proj_h = nn.Linear(h, h)
        self.proj_w = nn.Linear(w, w)
        self.fuse = nn.Conv2d(3 * dim, dim, 1)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class Stage(nn.Module):
    def __init__(self, dim, h, w, depth, expansion_factor):
        super().__init__()
        ff = dim * expansion_factor
        self.model = nn.ModuleList(nn.Sequential(
            PreNorm(nn.BatchNorm2d(dim), nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)),
            PreNorm(nn.BatchNorm2d(dim), SMLPBlock(h, w, dim)),
            nn.Identity(),
            PreNorm(nn.LayerNorm(dim), nn.Linear(dim, ff), nn.GELU(), nn.Identity(),
                    nn.Linear(ff, dim)),
        ) for _ in range(depth))
        self.patch_merge = nn.Sequential(nn.Identity(), PatchMerging(dim))


def patch_merging(m, x):
    """Swin PatchMerging of x (B, H, W, C): the four 2×2 phases on
    channels, LayerNorm, the bias-free reduction."""
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    x = nnf.layer_norm(x, m.norm.weight, m.norm.bias)
    return nnf.linear(x, m.reduction.weight)


class SparseMLPModel(Model):
    name = "sparse_mlp"

    def __init__(self, *, image_size, patch_size, in_channels, num_classes, d_model, depth,
                 expansion_factor, patcher_norm, seed):
        super().__init__()
        image_size, patch_size = pair(image_size), pair(patch_size)
        self.patch_size = patch_size
        dims = [d_model * 2 ** i for i in range(len(depth))]
        with torch.device("meta"):  # weights come from SDBuilder below
            stem = [nn.Conv2d(in_channels, d_model, patch_size, patch_size)]
            if patcher_norm:
                stem.append(nn.Sequential(nn.Identity(), nn.LayerNorm(d_model)))
            self.patcher = nn.Sequential(*stem)
            self.layers = nn.ModuleList(
                Stage(d, image_size[0] // patch_size[0] // 2 ** si,
                      image_size[1] // patch_size[1] // 2 ** si, depth[si], expansion_factor)
                for si, d in enumerate(dims))
            self.mlp_head = nn.Sequential(nn.Identity(), nn.LayerNorm(dims[-1]), nn.Identity(),
                                          nn.Linear(dims[-1], num_classes))
        self._load_init(_init_state_dict(
            seed, image_size=image_size, patch_size=patch_size, in_channels=in_channels,
            num_classes=num_classes, d_model=d_model, depth=depth,
            expansion_factor=expansion_factor, patcher_norm=patcher_norm))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        train = self.training
        x = nnf.patch_embed(x.permute(0, 2, 3, 1), self.patcher[0].weight, self.patcher[0].bias,
                            self.patch_size)
        if len(self.patcher) > 1:
            norm = self.patcher[1][1]
            x = nnf.layer_norm(x, norm.weight, norm.bias)

        def block(blk, h):
            dw = blk[0].fn[0]
            y = nnf.conv2d(nnf.bn(h, blk[0].norm, train), dw.weight, dw.bias, padding=1,
                           groups=h.shape[-1])
            h = h + y
            y = nnf.bn(h, blk[1].norm, train)
            sm = blk[1].fn[0]
            x_h = nnf.linear(y.movedim(1, -1), sm.proj_h.weight, sm.proj_h.bias).movedim(-1, 1)
            x_w = nnf.linear(y.movedim(2, -1), sm.proj_w.weight, sm.proj_w.bias).movedim(-1, 2)
            h = h + nnf.conv2d(torch.cat([x_h, x_w, y], -1), sm.fuse.weight, sm.fuse.bias)
            ff = blk[3]
            y = nnf.layer_norm(h, ff.norm.weight, ff.norm.bias)
            y = nnf.gelu(nnf.linear(y, ff.fn[0].weight, ff.fn[0].bias))
            return h + nnf.linear(y, ff.fn[3].weight, ff.fn[3].bias)

        for si, stage in enumerate(self.layers):
            x = nnf.run_blocks(stage.model, x, block)
            if si + 1 < len(self.layers):
                x = patch_merging(stage.patch_merge[1], x)
        head = self.mlp_head
        x = nnf.layer_norm(x, head[1].weight, head[1].bias).mean((1, 2))
        return nnf.linear(x, head[3].weight, head[3].bias)


def SparseMLP(
    image_size=224,
    patch_size=4,
    in_channels=3,
    num_classes=1000,
    d_model=96,
    depth=[2, 10, 24, 2],
    expansion_factor=2,
    patcher_norm=False,
    seed=0,
    device="cuda",
):
    """SparseMLP with the JAX factory's signature and defaults, plus device (where the model is built, the card unless the
    caller asks for the CPU; with no card, "cuda" raises)."""
    return SparseMLPModel(
        image_size=image_size, patch_size=patch_size, in_channels=in_channels,
        num_classes=num_classes, d_model=d_model, depth=list(depth),
        expansion_factor=expansion_factor, patcher_norm=patcher_norm, seed=seed,
    ).place(device)
