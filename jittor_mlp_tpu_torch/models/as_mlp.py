"""AS-MLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/as_mlp.py``).

A Swin-style hierarchy on channel-last (NHWC) activations: patch embedding
(Conv2d k=s=patch as one matmul) and GroupNorm, then stages of blocks

    h = h + drop_path(AxialShift(GN(h)))
    h = h + drop_path(fc2(GELU(fc1(GN(h)))))

with a patch merging between stages (the four 2×2 phases concatenated, H
index first, then GN and a bias-free 1×1 reduction to twice the width), and
at the end GN, a spatial mean and the head. Every GroupNorm has one group,
every 1×1 conv is a matmul over the contiguous channel axis (``nnf.conv1x1``,
dynamic W8A8 under ``config.int8_mode()``). The axial-shift block is
conv1 → GN → GELU; the shift along W and along H of the same activation;
per-direction conv + GELU; sum; GN; conv3.

Parameter names are the torch reference's (``patch_embed.{proj,norm}``,
``layers.{i}.blocks.{j}.{norm1,norm2}``, ``...axial_shift.{conv1,conv2_1,
conv2_2,conv3,norm1,norm2}``, ``...mlp.{fc1,fc2}``,
``layers.{i}.downsample.{norm,reduction}``, ``norm``, ``head``).

The shift runs through ``ops.kernels.axial_shift`` (the CUDA kernel on a
CUDA tensor, forward and backward; its plain twin on the CPU), or with
``use_pallas=False`` through the plain twin under autograd. In training,
drop-path draws its masks from the ``generator`` given to ``forward``
(none: no drop-path), all of them before the first block, so that a block
recomputed under checkpointing applies the same masks.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.kernels.axial_shift import axial_shift
from ..ops.shift import axial_shift as axial_shift_plain
from ..utils import pair


def _init_state_dict(seed, *, in_chans, embed_dim, depths, mlp_ratio, as_bias, patch_norm,
                     patch_size, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", in_chans, embed_dim, patch_size)
    if patch_norm:
        b.group_norm("patch_embed.norm", embed_dim)
    for i, depth in enumerate(depths):
        dim = int(embed_dim * 2 ** i)
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}"
            b.group_norm(f"{pre}.norm1", dim)
            for cv in ("conv1", "conv2_1", "conv2_2", "conv3"):
                b.conv2d(f"{pre}.axial_shift.{cv}", dim, dim, 1, bias=as_bias)
            b.group_norm(f"{pre}.axial_shift.norm1", dim)
            b.group_norm(f"{pre}.axial_shift.norm2", dim)
            b.group_norm(f"{pre}.norm2", dim)
            b.conv2d(f"{pre}.mlp.fc1", dim, int(dim * mlp_ratio), 1)
            b.conv2d(f"{pre}.mlp.fc2", int(dim * mlp_ratio), dim, 1)
        if i < len(depths) - 1:
            b.group_norm(f"layers.{i}.downsample.norm", 4 * dim)
            b.conv2d(f"layers.{i}.downsample.reduction", 4 * dim, 2 * dim, 1, bias=False)
    b.group_norm("norm", int(embed_dim * 2 ** (len(depths) - 1)))
    b.linear("head", int(embed_dim * 2 ** (len(depths) - 1)), num_classes)
    return b.sd


def _gn(x, norm):
    return nnf.group_norm(x, norm.weight, norm.bias, num_groups=1)


def _conv(x, conv):
    return nnf.conv1x1(x, conv.weight, conv.bias)


class AxialShift(nn.Module):
    def __init__(self, dim, shift_size, as_bias):
        super().__init__()
        self.shift_size = shift_size
        self.conv1 = nn.Conv2d(dim, dim, 1, bias=as_bias)
        self.conv2_1 = nn.Conv2d(dim, dim, 1, bias=as_bias)
        self.conv2_2 = nn.Conv2d(dim, dim, 1, bias=as_bias)
        self.conv3 = nn.Conv2d(dim, dim, 1, bias=as_bias)
        self.norm1 = nn.GroupNorm(1, dim)
        self.norm2 = nn.GroupNorm(1, dim)

    def forward(self, x, shift):
        """x (B, H, W, C); ``shift(y, shift_size, axis)`` is the shift."""
        y = nnf.gelu(_gn(_conv(x, self.conv1), self.norm1))
        y_lr = nnf.gelu(_conv(shift(y, self.shift_size, 2), self.conv2_1))
        y_td = nnf.gelu(_conv(shift(y, self.shift_size, 1), self.conv2_2))
        return _conv(_gn(y_lr + y_td, self.norm2), self.conv3)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return _conv(nnf.gelu(_conv(x, self.fc1)), self.fc2)


class AxialShiftedBlock(nn.Module):
    def __init__(self, dim, shift_size, mlp_ratio, as_bias, drop_path_rate):
        super().__init__()
        self.drop_path_rate = drop_path_rate  # a float, not a parameter
        self.norm1 = nn.GroupNorm(1, dim)
        self.axial_shift = AxialShift(dim, shift_size, as_bias)
        self.norm2 = nn.GroupNorm(1, dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, h, shift, masks=None):
        """masks: this block's two drop-path masks, or None (no drop-path)."""
        m1, m2 = masks or (None, None)
        train, rate = masks is not None, self.drop_path_rate
        y = self.axial_shift(_gn(h, self.norm1), shift)
        h = h + nnf.drop_path(y, rate, train, mask=m1)
        y = self.mlp(_gn(h, self.norm2))
        return h + nnf.drop_path(y, rate, train, mask=m2)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.GroupNorm(1, 4 * dim)
        self.reduction = nn.Conv2d(4 * dim, 2 * dim, 1, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return _conv(_gn(x, self.norm), self.reduction)


class BasicLayer(nn.Module):
    def __init__(self, dim, shift_size, mlp_ratio, as_bias, rates, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            AxialShiftedBlock(dim, shift_size, mlp_ratio, as_bias, float(r)) for r in rates)
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, in_chans, embed_dim, patch_size, patch_norm):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.GroupNorm(1, embed_dim) if patch_norm else None


class ASMLP(Model):
    name = "as_mlp"
    stochastic = True  # drop-path: the train forward takes a generator

    def __init__(self, *, img_size, patch_size, in_chans, num_classes, embed_dim, depths,
                 shift_size, mlp_ratio, as_bias, drop_path_rate, patch_norm, use_checkpoint,
                 use_pallas, seed):
        super().__init__()
        ih, iw = pair(img_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("image size must be divisible by patch size")
        self.patch_size = (ph, pw)
        self.use_checkpoint = use_checkpoint
        self.use_pallas = use_pallas
        # stochastic-depth decay rule (the JAX factory's linspace, in float32)
        dpr = np.linspace(0, drop_path_rate, sum(depths), dtype=np.float32)
        offsets = np.cumsum([0, *depths])
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = PatchEmbed(in_chans, embed_dim, self.patch_size, patch_norm)
            self.layers = nn.ModuleList(
                BasicLayer(int(embed_dim * 2 ** i), shift_size, mlp_ratio, as_bias,
                           dpr[offsets[i]:offsets[i + 1]], i < len(depths) - 1)
                for i in range(len(depths)))
            num_features = int(embed_dim * 2 ** (len(depths) - 1))
            self.norm = nn.GroupNorm(1, num_features)
            self.head = nn.Linear(num_features, num_classes)
        self._load_init(_init_state_dict(
            seed, in_chans=in_chans, embed_dim=embed_dim, depths=depths, mlp_ratio=mlp_ratio,
            as_bias=as_bias, patch_norm=patch_norm, patch_size=self.patch_size,
            num_classes=num_classes,
        ))

    def drop_path_masks(self, x, generator):
        """block → its two per-sample drop-path masks, drawn from
        ``generator`` in block order; empty in eval or without a generator.
        Blocks at rate 0 draw none."""
        if not self.training or generator is None:
            return {}
        return {blk: tuple(nnf.drop_path_mask(x.shape[0], blk.drop_path_rate, generator,
                                              x.device) for _ in range(2))
                for layer in self.layers for blk in layer.blocks if blk.drop_path_rate > 0}

    def forward(self, x, generator=None):
        """x: (B, C, H, W) → logits (B, num_classes). ``generator``: the
        drop-path random source in training."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        pe = self.patch_embed
        x = nnf.patch_embed(x, pe.proj.weight, pe.proj.bias, self.patch_size)
        if pe.norm is not None:
            x = _gn(x, pe.norm)
        masks = self.drop_path_masks(x, generator)
        shift = axial_shift if self.use_pallas else axial_shift_plain
        for layer in self.layers:
            x = nnf.run_blocks(layer.blocks, x, lambda blk, h: blk(h, shift, masks.get(blk)),
                               remat=self.use_checkpoint)
            if layer.downsample is not None:
                x = layer.downsample(x)
        x = _gn(x, self.norm).mean((1, 2))
        return nnf.linear(x, self.head.weight, self.head.bias)


def AS_MLP(
    img_size=224,
    patch_size=4,
    in_chans=3,
    num_classes=1000,
    embed_dim=96,
    depths=(2, 2, 6, 2),
    shift_size=5,
    mlp_ratio=4.0,
    as_bias=True,
    drop_rate=0.0,
    drop_path_rate=0.1,
    patch_norm=True,
    use_checkpoint=False,
    seed=0,
    use_pallas=True,
    device="cuda",
    **kwargs,
):
    """AS-MLP; the defaults are AS-MLP-T @224. The JAX factory's signature,
    plus: use_pallas (True runs the shift through the hand-written CUDA
    kernel, forward and backward; False through the plain twin under
    autograd) and device (where the model is built, the card unless the
    caller asks for the CPU; with no card, "cuda" raises). drop_rate is
    accepted and unused and other keyword arguments are ignored, as in
    JAX, except that block_runner must be None: the parallel runners are
    not ported yet. use_checkpoint checkpoints every block."""
    del drop_rate  # unused, as in the JAX factory
    if kwargs.get("block_runner") is not None:
        raise NotImplementedError("block_runner is not supported by the port yet")
    return ASMLP(
        img_size=img_size, patch_size=patch_size, in_chans=in_chans, num_classes=num_classes,
        embed_dim=embed_dim, depths=list(depths), shift_size=shift_size, mlp_ratio=mlp_ratio,
        as_bias=as_bias, drop_path_rate=drop_path_rate, patch_norm=patch_norm,
        use_checkpoint=use_checkpoint, use_pallas=use_pallas, seed=seed,
    ).place(device)
