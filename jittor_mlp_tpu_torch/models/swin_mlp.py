"""SwinMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/swin_mlp.py``).

A Swin hierarchy whose window attention is a spatial MLP: patch embedding
(Conv2d k=s=patch as one matmul) and LayerNorm, an optional absolute
position embedding (``ape``), then stages of blocks

    h = h + reverse(spatial_mlp(partition(pad(LN(h)))))   (cropped)
    h = h + fc2(GELU(fc1(LN(h))))

with Swin's patch merging between stages (the four 2×2 phases concatenated,
H index first, then LN and a bias-free Linear to twice the width), and LN,
a token mean and the head at the end.

The spatial MLP is the reference's grouped Conv1d(nH·ws², nH·ws², k=1,
groups=nH): a per-head product over the ws² positions of each window,
its weight (nH·ws², ws², 1) read as (nH, ws², ws²). Windows come from
``ops.window.window_partition`` and go back through ``window_reverse``.
Odd blocks of a stage shift: they pad top and left by ws − shift and
bottom and right by shift with zeros, and crop the padding off after the
reverse (no roll). The window is clamped to min(res), and blocks shift
(by ws // 2) only where min(res) > window_size.

Under ``config.int8_mode()`` the Linear layers and the patch embedding run
as dynamic W8A8; the spatial MLP's product stays in the compute dtype, as
in the JAX package. ``drop_rate`` is accepted and unused, as in the JAX
package; drop-path is applied in neither eval nor training (the training
path is not ported yet). ``use_checkpoint`` checkpoints every block.

Parameter names are the torch reference's (``patch_embed.{proj,norm}``,
``absolute_pos_embed``, ``layers.{i}.blocks.{j}.{norm1,spatial_mlp,norm2,
mlp.fc1,mlp.fc2}``, ``layers.{i}.downsample.{norm,reduction}``, ``norm``,
``head``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.window import window_partition, window_reverse
from ..utils import pair


def _init_state_dict(seed, *, in_chans, embed_dim, patch_size, res0, depths, num_heads,
                     windows, mlp_ratio, patch_norm, ape, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", in_chans, embed_dim, patch_size)
    if patch_norm:
        b.layer_norm("patch_embed.norm", embed_dim)
    if ape:
        b.trunc_normal_("absolute_pos_embed", (1, res0[0] * res0[1], embed_dim), std=0.02)
    for i, depth in enumerate(depths):
        dim, ws = int(embed_dim * 2 ** i), windows[i]
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}"
            b.layer_norm(f"{pre}.norm1", dim)
            b.conv1d(f"{pre}.spatial_mlp", ws * ws, num_heads[i] * ws * ws)
            b.layer_norm(f"{pre}.norm2", dim)
            b.linear(f"{pre}.mlp.fc1", dim, int(dim * mlp_ratio))
            b.linear(f"{pre}.mlp.fc2", int(dim * mlp_ratio), dim)
        if i < len(depths) - 1:
            b.layer_norm(f"layers.{i}.downsample.norm", 4 * dim)
            b.linear(f"layers.{i}.downsample.reduction", 4 * dim, 2 * dim, bias=False)
    num_features = int(embed_dim * 2 ** (len(depths) - 1))
    b.layer_norm("norm", num_features)
    b.linear("head", num_features, num_classes)
    return b.sd


def _ln(x, norm):
    return nnf.layer_norm(x, norm.weight, norm.bias)


def _linear(x, layer):
    return nnf.linear(x, layer.weight, layer.bias)


def spatial_mlp(win, conv, num_heads):
    """The grouped Conv1d on windows (N, ws², C), C = nH·c: per head, the
    (ws², ws²) weight applied over the window positions."""
    N, ws2, C = win.shape
    w = conv.weight[:, :, 0].reshape(num_heads, ws2, ws2)
    xh = win.reshape(N, ws2, num_heads, C // num_heads).permute(2, 1, 0, 3)  # h, i, n, c
    y = torch.matmul(w, xh.reshape(num_heads, ws2, -1)).reshape(num_heads, ws2, N, -1)
    y = y + conv.bias.reshape(num_heads, ws2, 1, 1)
    return y.permute(2, 1, 0, 3).reshape(N, ws2, C)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinMLPBlock(nn.Module):
    def __init__(self, dim, res, num_heads, window_size, shift_size, mlp_ratio):
        super().__init__()
        self.res, self.num_heads = res, num_heads
        self.window_size, self.shift_size = window_size, shift_size
        ws2 = window_size * window_size
        self.norm1 = nn.LayerNorm(dim)
        self.spatial_mlp = nn.Conv1d(num_heads * ws2, num_heads * ws2, 1, groups=num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        """x: (B, H·W, C)."""
        (H, W), ws, s = self.res, self.window_size, self.shift_size
        B, _, C = x.shape
        y = _ln(x, self.norm1).reshape(B, H, W, C)
        if s > 0:  # zero padding: left and top ws - s, right and bottom s
            y = F.pad(y, (0, 0, ws - s, s, ws - s, s))
        Hp, Wp = y.shape[1], y.shape[2]
        win = window_partition(y, ws).reshape(-1, ws * ws, C)
        win = spatial_mlp(win, self.spatial_mlp, self.num_heads)
        y = window_reverse(win.reshape(-1, ws, ws, C), ws, Hp, Wp)
        if s > 0:
            y = y[:, ws - s:Hp - s, ws - s:Wp - s, :]
        x = x + y.reshape(B, H * W, C)
        return x + _linear(nnf.gelu(_linear(_ln(x, self.norm2), self.mlp.fc1)), self.mlp.fc2)


class PatchMerging(nn.Module):
    def __init__(self, res, dim):
        super().__init__()
        self.res = res
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        (H, W), B, C = self.res, x.shape[0], x.shape[-1]
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1).reshape(B, (H // 2) * (W // 2), 4 * C)
        return nnf.linear(_ln(x, self.norm), self.reduction.weight)


class BasicLayer(nn.Module):
    def __init__(self, dim, res, depth, num_heads, window_size, shift, mlp_ratio, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinMLPBlock(dim, res, num_heads, window_size, 0 if j % 2 == 0 else shift,
                         mlp_ratio)
            for j in range(depth))
        self.downsample = PatchMerging(res, dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, in_chans, embed_dim, patch_size, patch_norm):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim) if patch_norm else None


class SwinMLPModel(Model):
    name = "swin_mlp"

    def __init__(self, *, img_size, patch_size, in_chans, num_classes, embed_dim, depths,
                 num_heads, window_size, mlp_ratio, ape, patch_norm, use_checkpoint, seed):
        super().__init__()
        ih, iw = pair(img_size)
        ph, pw = pair(patch_size)
        self.patch_size = (ph, pw)
        self.use_checkpoint = use_checkpoint
        res0 = (ih // ph, iw // pw)
        stages = []
        for i in range(len(depths)):
            res = (res0[0] // 2 ** i, res0[1] // 2 ** i)
            ws = min(res) if min(res) <= window_size else window_size
            shift = ws // 2 if min(res) > window_size else 0
            stages.append((int(embed_dim * 2 ** i), res, ws, shift))
        num_features = int(embed_dim * 2 ** (len(depths) - 1))
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = PatchEmbed(in_chans, embed_dim, self.patch_size, patch_norm)
            self.absolute_pos_embed = (
                nn.Parameter(torch.empty(1, res0[0] * res0[1], embed_dim)) if ape else None)
            self.layers = nn.ModuleList(
                BasicLayer(dim, res, depths[i], num_heads[i], ws, shift, mlp_ratio,
                           i < len(depths) - 1)
                for i, (dim, res, ws, shift) in enumerate(stages))
            self.norm = nn.LayerNorm(num_features)
            self.head = nn.Linear(num_features, num_classes)
        self._load_init(_init_state_dict(
            seed, in_chans=in_chans, embed_dim=embed_dim, patch_size=self.patch_size, res0=res0,
            depths=depths, num_heads=num_heads, windows=[ws for *_, ws, _ in stages],
            mlp_ratio=mlp_ratio, patch_norm=patch_norm, ape=ape, num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        pe = self.patch_embed
        x = nnf.patch_embed(x, pe.proj.weight, pe.proj.bias, self.patch_size)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        if pe.norm is not None:
            x = _ln(x, pe.norm)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed
        for layer in self.layers:
            x = nnf.run_blocks(layer.blocks, x, lambda blk, h: blk(h), remat=self.use_checkpoint)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return _linear(_ln(x, self.norm).mean(1), self.head)


def SwinMLP(
    img_size=224,
    patch_size=4,
    in_chans=3,
    num_classes=1000,
    embed_dim=96,
    depths=[2, 2, 6, 2],
    num_heads=[3, 6, 12, 24],
    window_size=7,
    mlp_ratio=4.0,
    drop_rate=0.0,
    drop_path_rate=0.1,
    ape=False,
    patch_norm=True,
    use_checkpoint=False,
    seed=0,
    device="cuda",
    **kwargs,
):
    """SwinMLP; the defaults are Swin-MLP-T @224. The JAX factory's
    signature, plus device (where the model is built, the card unless the
    caller asks for the CPU; with no card, "cuda" raises). drop_rate is
    accepted and unused, as in JAX; drop_path_rate is accepted, and the
    port applies no drop-path (its training path is not ported yet). Other
    keyword arguments are ignored, as in JAX, except that block_runner must
    be None: the parallel runners are not ported yet. use_checkpoint
    checkpoints every block."""
    del drop_rate, drop_path_rate  # see the docstring
    if kwargs.get("block_runner") is not None:
        raise NotImplementedError("block_runner is not supported by the port yet")
    return SwinMLPModel(
        img_size=img_size, patch_size=patch_size, in_chans=in_chans, num_classes=num_classes,
        embed_dim=embed_dim, depths=list(depths), num_heads=list(num_heads),
        window_size=window_size, mlp_ratio=mlp_ratio, ape=ape, patch_norm=patch_norm,
        use_checkpoint=use_checkpoint, seed=seed,
    ).place(device)
