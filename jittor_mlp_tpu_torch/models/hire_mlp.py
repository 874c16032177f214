"""HireMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/hire_mlp.py``).

A hierarchy on NHWC activations: a 7×7 stride-``patch_size`` Conv2d stem
(padding 3), stages of blocks

    h = h + hire(LN(h))
    h = h + fn.3(GELU(fn.0(LN(h))))

with a 3×3 stride-2 Conv2d (padding 1) between stages, and at the end
LayerNorm, a spatial mean and the head. ``hire`` pads H and W at the end up
to the next multiple of the region sizes h and w (a full extra region where
a side is already a multiple) in one of four modes (constant, circular,
reflect, replicate), then sums three paths and crops:

- H path: roll H by the block's ``step``, fold each of the gh = Hp / h
  groups of h rows ('(h group)', h outer) into the channels, '(c h)'
  c-major, run the bottleneck FF ``proj_h.net.{0,2}`` (two 1×1 convs, GELU
  between), unfold, roll back;
- W path: the same along W with ``proj_w``;
- channel path: ``proj_c``, a 1×1 conv.

Block j of a stage rolls by ``cross_region_step`` iff (j + 1) %
``cross_region_interval`` == 0, else not at all.

The bottleneck FFs are ``torch.matmul`` on the folded layout, which the
JAX package writes as ``jnp.einsum``: they stay out of int8. ``proj_c``,
the FF layers and the head run as dynamic W8A8 under
``config.int8_mode()``; the stem and the stride-2 convs are ``F.conv2d``.

Parameter names are the torch reference's (``patcher.reduction.0``,
``patcher.reduction.1.1`` with ``patcher_norm``,
``layers.{s}.model.{j}.0.{norm,fn.0.proj_h.net.{0,2},fn.0.proj_w.net.{0,2},
fn.0.proj_c}``, ``layers.{s}.model.{j}.1.{norm,fn.0,fn.3}``,
``layers.{s}.patch_merge.1.reduction.0``, ``mlp_head.{0,2}``). The last
stage's ``patch_merge`` is in the reference's state dict but unused by its
forward (and absent from the JAX params): the port holds it and never runs
it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..utils import pair

PADDING_TYPES = ("constant", "circular", "reflect", "replicate")


def _init_state_dict(seed, *, in_channels, d_model, h, w, depth, expansion_factor,
                     patcher_norm, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    n_stages = len(depth)
    b = SDBuilder(seed)
    b.conv2d("patcher.reduction.0", in_channels, d_model[0], 7)
    if patcher_norm:
        b.layer_norm("patcher.reduction.1.1", d_model[0])
    for si in range(n_stages):
        d = d_model[si]
        for j in range(depth[si]):
            pre = f"layers.{si}.model.{j}"
            b.layer_norm(f"{pre}.0.norm", d)
            b.conv2d(f"{pre}.0.fn.0.proj_h.net.0", h[si] * d, d // 2, 1)
            b.conv2d(f"{pre}.0.fn.0.proj_h.net.2", d // 2, h[si] * d, 1)
            b.conv2d(f"{pre}.0.fn.0.proj_w.net.0", w[si] * d, d // 2, 1)
            b.conv2d(f"{pre}.0.fn.0.proj_w.net.2", d // 2, w[si] * d, 1)
            b.conv2d(f"{pre}.0.fn.0.proj_c", d, d, 1)
            b.layer_norm(f"{pre}.1.norm", d)
            b.linear(f"{pre}.1.fn.0", d, d * expansion_factor)
            b.linear(f"{pre}.1.fn.3", d * expansion_factor, d)
        d_out = d_model[si + 1] if si + 1 < n_stages else d_model[-1]
        b.conv2d(f"layers.{si}.patch_merge.1.reduction.0", d, d_out, 3)
    b.layer_norm("mlp_head.0", d_model[-1])
    b.linear("mlp_head.2", d_model[-1], num_classes)
    return b.sd


def _pad_end(x, axis, p, mode):
    """x padded by p entries at the end of ``axis`` in ``mode``, as
    ``jnp.pad`` pads (any p: circular and reflect repeat with their
    period)."""
    n = x.shape[axis]
    if mode == "constant":
        shape = list(x.shape)
        shape[axis] = p
        return torch.cat([x, x.new_zeros(shape)], axis)
    i = torch.arange(n, n + p, device=x.device)
    if mode == "circular":
        src = i % n
    elif mode == "replicate":
        src = i.clamp(max=n - 1)
    elif n == 1:  # reflect about a single entry: the entry itself
        src = torch.zeros_like(i)
    else:  # reflect, without repeating the edge: period 2(n - 1)
        j = i % (2 * (n - 1))
        src = torch.where(j < n, j, 2 * (n - 1) - j)
    return torch.cat([x, x.index_select(axis, src)], axis)


class HireFF(nn.Module):
    """``proj_h`` / ``proj_w``: the region bottleneck, two 1×1 convs over
    the (C, region) channels, '(c r)' c-major."""

    def __init__(self, dim, region):
        super().__init__()
        self.net = nn.Sequential(nn.Conv2d(region * dim, dim // 2, 1), nn.GELU(),
                                 nn.Conv2d(dim // 2, region * dim, 1))

    def forward(self, x):
        """x (..., C·r) → (..., C·r)."""
        w0, w2 = self.net[0], self.net[2]
        t = torch.matmul(x, w0.weight[:, :, 0, 0].t().to(x.dtype)) + w0.bias
        t = nnf.gelu(t)
        return torch.matmul(t, w2.weight[:, :, 0, 0].t().to(x.dtype)) + w2.bias


class HireMLPBlock(nn.Module):
    def __init__(self, dim, h, w):
        super().__init__()
        self.proj_h = HireFF(dim, h)
        self.proj_w = HireFF(dim, w)
        self.proj_c = nn.Conv2d(dim, dim, 1)


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


class HireLayer(nn.Module):
    """One block: ``0`` the hire branch, ``1`` the FF, each a PreNorm;
    ``step`` its cross-region roll (0: none)."""

    def __init__(self, dim, h, w, expansion_factor, step):
        super().__init__()
        self.step = step
        self.add_module("0", PreNorm(dim, nn.Sequential(HireMLPBlock(dim, h, w))))
        self.add_module("1", PreNorm(dim, nn.Sequential(
            nn.Linear(dim, dim * expansion_factor), nn.GELU(), nn.Identity(),
            nn.Linear(dim * expansion_factor, dim), nn.Identity())))

    def __getitem__(self, i):
        return self._modules[str(i)]


def hire(blk, x, h, w, step, padding_type):
    """The hire branch of a block on x (B, H, W, C)."""
    B, H, W, C = x.shape
    x = _pad_end(_pad_end(x, 1, h - H % h, padding_type), 2, w - W % w, padding_type)
    Hp, Wp = x.shape[1:3]
    gh, gw = Hp // h, Wp // w
    # H path: rows '(h group)' → channels '(c h)', the FF, and back
    xh = torch.roll(x, step, 1) if step else x
    xh = xh.reshape(B, h, gh, Wp, C).permute(0, 2, 3, 4, 1).reshape(B, gh, Wp, C * h)
    xh = blk.proj_h(xh).reshape(B, gh, Wp, C, h).permute(0, 4, 1, 2, 3).reshape(B, Hp, Wp, C)
    if step:
        xh = torch.roll(xh, -step, 1)
    # W path: columns '(w group)' → channels '(c w)'
    xw = torch.roll(x, step, 2) if step else x
    xw = xw.reshape(B, Hp, w, gw, C).permute(0, 1, 3, 4, 2).reshape(B, Hp, gw, C * w)
    xw = blk.proj_w(xw).reshape(B, Hp, gw, C, w).permute(0, 1, 4, 2, 3).reshape(B, Hp, Wp, C)
    if step:
        xw = torch.roll(xw, -step, 2)
    xc = nnf.conv1x1(x, blk.proj_c.weight, blk.proj_c.bias)
    return (xc + xh + xw)[:, :H, :W, :]


class Reduction(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        self.reduction = nn.Sequential(*layers)


class Stage(nn.Module):
    def __init__(self, dim, h, w, expansion_factor, steps, d_out):
        super().__init__()
        self.model = nn.ModuleList(HireLayer(dim, h, w, expansion_factor, s) for s in steps)
        self.patch_merge = nn.Sequential(nn.Identity(),
                                         Reduction(nn.Conv2d(dim, d_out, 3, 2, 1)))


class HireMLPModel(Model):
    name = "hire_mlp"

    def __init__(self, *, patch_size, in_channels, num_classes, d_model, h, w,
                 cross_region_step, cross_region_interval, depth, expansion_factor,
                 patcher_norm, padding_type, seed):
        super().__init__()
        if padding_type not in PADDING_TYPES:
            raise ValueError(f"padding_type {padding_type!r} not in {PADDING_TYPES}")
        n_stages = len(depth)
        self.patch_size = pair(patch_size)
        self.h, self.w, self.padding_type = list(h), list(w), padding_type
        with torch.device("meta"):  # weights come from SDBuilder below
            stem = [nn.Conv2d(in_channels, d_model[0], 7, self.patch_size, 3)]
            if patcher_norm:
                stem.append(nn.Sequential(nn.Identity(), nn.LayerNorm(d_model[0])))
            self.patcher = Reduction(*stem)
            self.layers = nn.ModuleList(
                Stage(d_model[si], h[si], w[si], expansion_factor,
                      [cross_region_step[si] if (j + 1) % cross_region_interval == 0 else 0
                       for j in range(depth[si])],
                      d_model[si + 1] if si + 1 < n_stages else d_model[-1])
                for si in range(n_stages))
            self.mlp_head = nn.Sequential(nn.LayerNorm(d_model[-1]), nn.Identity(),
                                          nn.Linear(d_model[-1], num_classes))
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, d_model=d_model, h=h, w=w, depth=depth,
            expansion_factor=expansion_factor, patcher_norm=patcher_norm,
            num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        stem = self.patcher.reduction
        x = nnf.conv2d(x.permute(0, 2, 3, 1), stem[0].weight, stem[0].bias,  # NCHW → NHWC
                       stride=self.patch_size, padding=3)
        if len(stem) > 1:
            x = nnf.layer_norm(x, stem[1][1].weight, stem[1][1].bias)
        for si, stage in enumerate(self.layers):
            h, w = self.h[si], self.w[si]

            def block(layer, x, h=h, w=w):
                t, c = layer[0], layer[1]
                y = nnf.layer_norm(x, t.norm.weight, t.norm.bias)
                x = x + hire(t.fn[0], y, h, w, layer.step, self.padding_type)
                y = nnf.layer_norm(x, c.norm.weight, c.norm.bias)
                y = nnf.gelu(nnf.linear(y, c.fn[0].weight, c.fn[0].bias))
                return x + nnf.linear(y, c.fn[3].weight, c.fn[3].bias)

            x = nnf.run_blocks(stage.model, x, block)
            if si + 1 < len(self.layers):
                merge = stage.patch_merge[1].reduction[0]
                x = nnf.conv2d(x, merge.weight, merge.bias, stride=2, padding=1)
        head = self.mlp_head
        x = nnf.layer_norm(x, head[0].weight, head[0].bias).mean((1, 2))
        return nnf.linear(x, head[2].weight, head[2].bias)


def HireMLP(
    patch_size=4,
    in_channels=3,
    num_classes=1000,
    d_model=[64, 128, 320, 512],
    h=[4, 3, 3, 2],
    w=[4, 3, 3, 2],
    cross_region_step=[2, 2, 1, 1],
    cross_region_interval=2,
    depth=[4, 6, 24, 3],
    expansion_factor=2,
    patcher_norm=False,
    padding_type="circular",
    seed=0,
    device="cuda",
):
    """HireMLP; the defaults are Hire-MLP-Tiny. The JAX factory's signature,
    plus device (where the model is built, the card unless the caller asks
    for the CPU; with no card, "cuda" raises)."""
    return HireMLPModel(
        patch_size=patch_size, in_channels=in_channels, num_classes=num_classes,
        d_model=list(d_model), h=list(h), w=list(w), cross_region_step=list(cross_region_step),
        cross_region_interval=cross_region_interval, depth=list(depth),
        expansion_factor=expansion_factor, patcher_norm=patcher_norm,
        padding_type=padding_type, seed=seed,
    ).place(device)
