"""ActiveMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/active_mlp.py``).

A hierarchy on NHWC activations: a 7×7 stride-4 Conv2d stem (padding 2)
and stages of blocks

    h = h + atm(LN(h), offsets)
    h = h + fc2(GELU(fc1(LN(h))))

with a 3×3 stride-2 Conv2d (padding 1), ``downsample``, on the last block
of each stage but the last, and at the end LayerNorm, a token mean and the
head. Block j of a stage makes new offsets where j % intv == 0 and j is not
the stage's last: first the PEG, a depthwise 3×3 conv added to h
(``pos_blocks.{i}``), then ``offset_layer`` (LN → Linear to 2C / share
channels, one offset a group of ``share_dims[i]`` channels: the first C /
share for the W branch, the rest for the H branch); the blocks after it
use those offsets until the next block that makes them. ``atm`` mixes three
branches, ATMOp ``atm_w`` (a learned sample along W, then a 1×1 product),
``atm_h`` (along H) and the channel Linear ``atm_c``, by a softmax over the
branches of ``fusion`` (fc1 → GELU → fc2) of their spatial mean, then
projects (``proj``). ATMOp is ``ops.deform.atm_op``: an exact gather and
lerp, positions in float32.

``offset_band``: an int D clamps every offset to ±D before sampling (the
JAX package's banded sampler with saturation gives the same); "auto" and
None sample exactly. The JAX package's "auto" picks a TPU lowering from a
bound on the offsets taken when its params are set; the port has no
lowering to pick, so its "auto" is exact whatever the weights become.

The ATM products stay out of int8 (``jnp.matmul`` in JAX); ``atm_c``,
``fusion``, ``proj``, ``offset_layer.1``, the MLP and the head run as
dynamic W8A8 under ``config.int8_mode()``; the stem, the PEG and the
downsamples are ``F.conv2d``. Drop-path (training) is not ported: the
train-mode forward applies none.

Parameter names are the torch reference's (``patch_embed.proj``,
``blocks.{i}.{j}.{norm1,norm2,atm.{atm_c,atm_h,atm_w,fusion.{fc1,fc2},proj},
mlp.{fc1,fc2},offset_layer.{0,1},downsample.proj}``, ``pos_blocks.{i}.proj``,
``norm``, ``head``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.deform import atm_op


def _makes_offsets(j, depth, intv):
    return j % intv == 0 and j != depth - 1


def _init_state_dict(seed, *, in_chans, depths, embed_dims, mlp_ratios, share_dims, intv,
                     num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", in_chans, embed_dims[0], 7)
    for i, d in enumerate(embed_dims):
        for j in range(depths[i]):
            pre = f"blocks.{i}.{j}"
            b.layer_norm(f"{pre}.norm1", d)
            b.linear(f"{pre}.atm.atm_c", d, d, bias=False)
            b.conv2d(f"{pre}.atm.atm_h", d, d, 1)
            b.conv2d(f"{pre}.atm.atm_w", d, d, 1)
            b.linear(f"{pre}.atm.fusion.fc1", d, d // 4)
            b.linear(f"{pre}.atm.fusion.fc2", d // 4, d * 3)
            b.linear(f"{pre}.atm.proj", d, d)
            b.layer_norm(f"{pre}.norm2", d)
            b.linear(f"{pre}.mlp.fc1", d, int(d * mlp_ratios[i]))
            b.linear(f"{pre}.mlp.fc2", int(d * mlp_ratios[i]), d)
            if _makes_offsets(j, depths[i], intv):
                b.layer_norm(f"{pre}.offset_layer.0", d)
                b.linear(f"{pre}.offset_layer.1", d, d * 2 // share_dims[i])
            if i < len(depths) - 1 and j == depths[i] - 1:
                b.conv2d(f"{pre}.downsample.proj", d, embed_dims[i + 1], 3)
        b.conv2d(f"pos_blocks.{i}.proj", d, d, 3, groups=d)
    b.layer_norm("norm", embed_dims[-1])
    b.linear("head", embed_dims[-1], num_classes)
    return b.sd


def _linear(x, layer):
    return nnf.linear(x, layer.weight, layer.bias)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return _linear(nnf.gelu(_linear(x, self.fc1)), self.fc2)


class ATMLayer(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.atm_c = nn.Linear(dim, dim, bias=False)
        self.atm_h = nn.Conv2d(dim, dim, 1)
        self.atm_w = nn.Conv2d(dim, dim, 1)
        self.fusion = Mlp(dim, dim // 4, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, offset, share, band):
        """x (B, H, W, C); offset (B, H, W, 2C / share): the W branch's group
        offsets, then the H branch's."""
        B, C = x.shape[0], x.shape[-1]
        g = C // share
        w = atm_op(x, offset[..., :g], self.atm_w.weight, self.atm_w.bias, "w", share, band)
        h = atm_op(x, offset[..., g:], self.atm_h.weight, self.atm_h.bias, "h", share, band)
        c = _linear(x, self.atm_c)
        a = self.fusion((w + h + c).mean((1, 2)))
        a = nnf.softmax(a.reshape(B, C, 3).permute(2, 0, 1), dim=0)[:, :, None, None, :]
        return _linear(w * a[0] + h * a[1] + c * a[2], self.proj)


class Proj(nn.Module):
    """A conv named ``proj``: the stem, a downsample, a PEG."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.proj = nn.Conv2d(*args, **kwargs)


class ActiveBlock(nn.Module):
    def __init__(self, dim, mlp_ratio, share, makes_offsets, down):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.atm = ATMLayer(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        if makes_offsets:
            self.offset_layer = nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, dim * 2 // share))
        if down is not None:
            self.downsample = Proj(dim, down, 3, 2, 1)


class ActiveMLPModel(Model):
    name = "active_mlp"

    def __init__(self, *, in_chans, num_classes, depths, embed_dims, mlp_ratios, share_dims,
                 intv, offset_band, seed):
        super().__init__()
        if not (offset_band in ("auto", None) or isinstance(offset_band, int)):
            raise ValueError(f"offset_band {offset_band!r}: 'auto', None or an int")
        n_stages = len(depths)
        self.share_dims = list(share_dims)
        self.band = offset_band if isinstance(offset_band, int) else None
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = Proj(in_chans, embed_dims[0], 7, 4, 2)
            self.blocks = nn.ModuleList(
                nn.ModuleList(
                    ActiveBlock(embed_dims[i], mlp_ratios[i], share_dims[i],
                                _makes_offsets(j, depths[i], intv),
                                embed_dims[i + 1] if i < n_stages - 1 and j == depths[i] - 1
                                else None)
                    for j in range(depths[i]))
                for i in range(n_stages))
            self.pos_blocks = nn.ModuleList(Proj(d, d, 3, 1, 1, groups=d) for d in embed_dims)
            self.norm = nn.LayerNorm(embed_dims[-1])
            self.head = nn.Linear(embed_dims[-1], num_classes)
        self._load_init(_init_state_dict(
            seed, in_chans=in_chans, depths=depths, embed_dims=embed_dims,
            mlp_ratios=mlp_ratios, share_dims=share_dims, intv=intv, num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        pe = self.patch_embed.proj
        x = nnf.conv2d(x.permute(0, 2, 3, 1), pe.weight, pe.bias, stride=4, padding=2)
        offset = None
        for i, stage in enumerate(self.blocks):
            for blk in stage:
                if hasattr(blk, "offset_layer"):  # PEG, then new offsets
                    peg = self.pos_blocks[i].proj
                    x = nnf.conv2d(x, peg.weight, peg.bias, padding=1, groups=peg.groups) + x
                    norm, lin = blk.offset_layer
                    offset = _linear(nnf.layer_norm(x, norm.weight, norm.bias), lin)
                y = nnf.layer_norm(x, blk.norm1.weight, blk.norm1.bias)
                x = x + blk.atm(y, offset, self.share_dims[i], self.band)
                x = x + blk.mlp(nnf.layer_norm(x, blk.norm2.weight, blk.norm2.bias))
                if hasattr(blk, "downsample"):
                    ds = blk.downsample.proj
                    x = nnf.conv2d(x, ds.weight, ds.bias, stride=2, padding=1)
        x = nnf.layer_norm(x, self.norm.weight, self.norm.bias).mean((1, 2))
        return _linear(x, self.head)


def ActiveMLP(
    img_size=224,
    patch_size=4,
    in_chans=3,
    num_classes=1000,
    depths=[2, 2, 4, 2],
    embed_dims=[64, 128, 320, 512],
    mlp_ratios=[4, 4, 4, 4],
    share_dims=[1, 1, 1, 1],
    drop_path_rate=0.0,
    intv=2,
    seed=0,
    offset_band="auto",
    device="cuda",
    **kwargs,
):
    """ActiveMLP; the JAX factory's signature, plus device (where the model
    is built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises). offset_band: an int D clamps the offsets to ±D; "auto"
    and None sample exactly. As in JAX, the stem is always 7×7 stride 4,
    img_size, patch_size and other keyword arguments are accepted and
    unused; drop_path_rate has no effect in eval, and training is not
    ported yet."""
    del img_size, patch_size, drop_path_rate, kwargs  # see the docstring
    return ActiveMLPModel(
        in_chans=in_chans, num_classes=num_classes, depths=list(depths),
        embed_dims=list(embed_dims), mlp_ratios=list(mlp_ratios), share_dims=list(share_dims),
        intv=intv, offset_band=offset_band, seed=seed,
    ).place(device)


def ActivexTiny(pretrained=False, **kwargs):
    return ActiveMLP(depths=[2, 2, 4, 2], mlp_ratios=[4, 4, 4, 4],
                     embed_dims=[64, 128, 320, 512], share_dims=[2, 4, 4, 8],
                     intv=2, **kwargs)


def ActiveTiny(pretrained=False, **kwargs):
    return ActiveMLP(depths=[2, 3, 10, 3], mlp_ratios=[4, 4, 4, 4],
                     embed_dims=[64, 128, 320, 512], share_dims=[2, 4, 4, 8],
                     intv=2, **kwargs)


def ActiveSmall(pretrained=False, **kwargs):
    return ActiveMLP(depths=[3, 4, 18, 3], mlp_ratios=[8, 8, 4, 4],
                     embed_dims=[64, 128, 320, 512], share_dims=[2, 4, 4, 8],
                     intv=6, **kwargs)


def ActiveBase(pretrained=False, **kwargs):
    return ActiveMLP(depths=[3, 8, 27, 3], mlp_ratios=[8, 8, 4, 4],
                     embed_dims=[64, 128, 320, 512], share_dims=[2, 4, 4, 8],
                     intv=6, **kwargs)


def ActiveLarge(pretrained=False, **kwargs):
    return ActiveMLP(depths=[3, 4, 24, 3], mlp_ratios=[4, 4, 4, 4],
                     embed_dims=[96, 192, 384, 768], share_dims=[2, 4, 4, 8],
                     intv=6, **kwargs)
