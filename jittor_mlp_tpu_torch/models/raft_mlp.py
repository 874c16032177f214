"""RaftMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/raft_mlp.py``).

Levels of patch embedding and token / channel mixing blocks, then heads.
Four token mixing types (``token_mixing_type``):

- 'ser_pm' (default): serial permuted vertical and horizontal mixers, with
  ``raft_size`` channels riding along the mixed spatial axis and a
  LayerNorm over the channels in (c1 c2) order;
- 'sep_ln_codim_tm': axis mixers with a LayerNorm over the whole
  codimension;
- 'sep_ln_ch_tm': axis mixers with a LayerNorm over the channels only;
- 'original_tm': MLP-Mixer's token mixer over all H·W tokens.

Each mixer is LN → Linear → GELU → Linear plus the residual. A level whose
image size is not a multiple of its patch first resizes its NCHW input
bilinearly (half-pixel centres, an upsample) to ``ceil(img/p)·p``. The
levels keep the reference's NCHW layout between them. With ``shortcut``
every level has a head (LN, and but for the last a spatial mean and a
Linear to 2·last_dim) whose output gates the next one's as
``b[:, :D] * out + b[:, D:]``, in reverse order; ``gap`` takes the mean of
the last head too, else the classifier reads the flattened last level.

Every einops Rearrange is a reshape and a permute; each LayerNorm over a
non-last axis normalizes that axis in place (``_ln_axes``). ``dropout`` is
accepted and unused, as in the JAX package. Drop-path is applied in
neither eval nor training (the training path is not ported yet).

Parameter names are the torch reference's (``levels.{i}.fn.1`` the embed,
``levels.{i}.fn.{2+j}.{1,3,5}.{norm,norm.1,fn.0,fn.3}`` block j,
``heads.{k}.{1,4}``, ``classifier``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model

TOKEN_MIXING_TYPES = ["ser_pm", "sep_ln_codim_tm", "sep_ln_ch_tm", "original_tm"]


def _geometry(layers, in_channels, image_size):
    """Per level: input and output channels, depth, patch, the floor and
    ceil of img/p, raft size; and the final spatial size."""
    geo, img = [], image_size
    for i, layer in enumerate(layers):
        p = layer["patch_size"]
        geo.append({"in": in_channels if i == 0 else layers[i - 1]["dim"],
                    "out": layer["dim"], "depth": layer["depth"], "patch": p,
                    "bhw": img // p, "hw": math.ceil(img / p), "raft": layer.get("raft_size")})
        img = math.ceil(img / p)
    return geo, img


def _has_embed(g, token_mixing_type):
    return token_mixing_type == "original_tm" or g["patch"] != 1 or g["in"] == g["out"]


def _init_state_dict(seed, *, geo, final_hw, token_mixing_type, token_expansion_factor,
                     channel_expansion_factor, shortcut, gap, num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    tef, cef = token_expansion_factor, channel_expansion_factor
    for i, g in enumerate(geo):
        pre = f"levels.{i}.fn"
        if _has_embed(g, token_mixing_type):
            b.linear(f"{pre}.1", g["patch"] ** 2 * g["in"], g["out"])
        h = w = g["hw"]
        Co = g["out"]
        for j in range(g["depth"]):
            bp = f"{pre}.{2 + j}"
            if token_mixing_type == "original_tm":
                b.layer_norm(f"{bp}.1.norm.1", Co)
                b.linear(f"{bp}.1.fn.0", h * w, h * w * tef)
                b.linear(f"{bp}.1.fn.3", h * w * tef, h * w)
                b.layer_norm(f"{bp}.3.norm", Co)
                b.linear(f"{bp}.3.fn.0", Co, Co * cef)
                b.linear(f"{bp}.3.fn.3", Co * cef, Co)
                continue
            r = g["raft"] if token_mixing_type == "ser_pm" else 1
            codim = token_mixing_type == "sep_ln_codim_tm"
            b.layer_norm(f"{bp}.1.norm.1", Co * w if codim else Co)
            b.linear(f"{bp}.1.fn.0", h * r, h * r * tef)
            b.linear(f"{bp}.1.fn.3", h * r * tef, h * r)
            b.layer_norm(f"{bp}.3.norm.1", Co * h if codim else Co)
            b.linear(f"{bp}.3.fn.0", w * r, w * r * tef)
            b.linear(f"{bp}.3.fn.3", w * r * tef, w * r)
            b.layer_norm(f"{bp}.5.norm", Co)
            b.linear(f"{bp}.5.fn.0", Co, Co * cef)
            b.linear(f"{bp}.5.fn.3", Co * cef, Co)
    last = len(geo) - 1
    k = 0
    for i, g in enumerate(geo):
        if shortcut or i == last:
            b.layer_norm(f"heads.{k}.1", g["out"])
            if i != last:
                b.linear(f"heads.{k}.4", g["out"], geo[-1]["out"] * 2)
            k += 1
    b.linear("classifier", geo[-1]["out"] if gap else geo[-1]["out"] * final_hw ** 2,
             num_classes)
    return b.sd


def _ff(fn, x):
    """Block.fn: Linear → GELU → Linear over the last axis."""
    y = nnf.gelu(nnf.linear(x, fn[0].weight, fn[0].bias))
    return nnf.linear(y, fn[3].weight, fn[3].bias)


def _ln_axes(norm, x, axes, wshape):
    """LayerNorm over ``axes`` of x in place: float32 statistics, x̂ cast to
    x's dtype, the weight and bias reshaped onto ``axes``."""
    xf = x.float()
    mu = xf.mean(axes, keepdim=True)
    var = (xf - mu).square().mean(axes, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    bshape = [1] * x.dim()
    for a, s in zip(axes, wshape):
        bshape[a] = s
    return y * norm.weight.reshape(bshape).to(x.dtype) + norm.bias.reshape(bshape).to(x.dtype)


def _token_block(blk, x):
    """TokenBlock on (B, K, o): LN over K, FF over o, residual."""
    return _ff(blk.fn, _ln_axes(blk.norm[1], x, (1,), (x.shape[1],))) + x


def _sep_token_block(blk, x, channels, dim):
    """SpatiallySeparatedTokenBlock on (B, C·o1, o2): LN over C only."""
    B = x.shape[0]
    o1 = x.shape[1] // channels
    y = _ln_axes(blk.norm[1], x.reshape(B, channels, o1, dim), (1,), (channels,))
    return _ff(blk.fn, y.reshape(B, channels * o1, dim)) + x


def _permuted_block(blk, x, spatial, channels, raft):
    """PermutedBlock on (B, co·o1, r·spatial): LN over the channels in
    (c1 c2) order, the (co, r) axes of the 5-d view jointly; FF over
    r·spatial."""
    B = x.shape[0]
    co = channels // raft
    o1 = x.shape[1] // co
    y = _ln_axes(blk.norm[1], x.reshape(B, co, o1, raft, spatial), (1, 3), (co, raft))
    return _ff(blk.fn, y.reshape(B, co * o1, raft * spatial)) + x


def _channel_block(blk, x):
    return _ff(blk.fn, nnf.layer_norm(x, blk.norm.weight, blk.norm.bias)) + x


def _mlp(dim, hidden):
    """fn.0 and fn.3 are the Linears; 1 is the GELU, 2 and 4 dropouts."""
    return nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
                         nn.Linear(hidden, dim), nn.Identity())


class TokenBlock(nn.Module):
    """norm.1: the LayerNorm (norm.0 is a parameter-free Rearrange)."""

    def __init__(self, norm_dim, dim, hidden):
        super().__init__()
        self.norm = nn.Sequential(nn.Identity(), nn.LayerNorm(norm_dim))
        self.fn = _mlp(dim, hidden)


class ChannelBlock(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = _mlp(dim, hidden)


def _block(g, token_mixing_type, tef, cef):
    """One block of a level: indices 1, 3 (and 5) hold the mixers; the
    others are parameter-free Rearranges."""
    h = w = g["hw"]
    Co = g["out"]
    channel = ChannelBlock(Co, Co * cef)
    if token_mixing_type == "original_tm":
        return nn.Sequential(nn.Identity(), TokenBlock(Co, h * w, h * w * tef), nn.Identity(),
                             channel)
    r = g["raft"] if token_mixing_type == "ser_pm" else 1
    codim = token_mixing_type == "sep_ln_codim_tm"
    return nn.Sequential(
        nn.Identity(), TokenBlock(Co * w if codim else Co, h * r, h * r * tef),
        nn.Identity(), TokenBlock(Co * h if codim else Co, w * r, w * r * tef),
        nn.Identity(), channel)


class Level(nn.Module):
    """fn.1: the patch embedding (a Linear, or none); fn.{2+j}: block j."""

    def __init__(self, g, token_mixing_type, tef, cef):
        super().__init__()
        embed = (nn.Linear(g["patch"] ** 2 * g["in"], g["out"])
                 if _has_embed(g, token_mixing_type) else nn.Identity())
        self.fn = nn.Sequential(nn.Identity(), embed,
                                *(_block(g, token_mixing_type, tef, cef)
                                  for _ in range(g["depth"])))


class RaftMLPModel(Model):
    name = "raft_mlp"

    def __init__(self, *, layers, in_channels, image_size, num_classes, token_expansion_factor,
                 channel_expansion_factor, token_mixing_type, shortcut, gap, seed):
        super().__init__()
        if token_mixing_type not in TOKEN_MIXING_TYPES:
            raise ValueError(f"token_mixing_type {token_mixing_type!r} not in "
                             f"{TOKEN_MIXING_TYPES}")
        self.geo, final_hw = _geometry(layers, in_channels, image_size)
        self.token_mixing_type = token_mixing_type
        self.shortcut = shortcut
        self.gap = gap
        last = len(self.geo) - 1
        last_dim = self.geo[-1]["out"]
        tef, cef = token_expansion_factor, channel_expansion_factor
        with torch.device("meta"):  # weights come from SDBuilder below
            self.levels = nn.ModuleList(Level(g, token_mixing_type, tef, cef) for g in self.geo)
            self.heads = nn.ModuleList(
                nn.Sequential(nn.Identity(), nn.LayerNorm(g["out"]),
                              *((nn.Identity(), nn.Identity(), nn.Linear(g["out"], last_dim * 2))
                                if i != last else ()))
                for i, g in enumerate(self.geo) if shortcut or i == last)
            self.classifier = nn.Linear(last_dim if gap else last_dim * final_hw ** 2,
                                        num_classes)
        self._load_init(_init_state_dict(
            seed, geo=self.geo, final_hw=final_hw, token_mixing_type=token_mixing_type,
            token_expansion_factor=tef, channel_expansion_factor=cef, shortcut=shortcut,
            gap=gap, num_classes=num_classes))

    def level_forward(self, level, x, g):
        """x: (B, C_in, H, W) NCHW → (B, C_out, hw, hw)."""
        h = w = g["hw"]
        p, Co, r = g["patch"], g["out"], g["raft"]
        if g["bhw"] != g["hw"]:
            x = F.interpolate(x, size=(h * p, w * p), mode="bilinear", align_corners=False)
        B, C = x.shape[0], x.shape[1]
        # 'b c (h p1) (w p2) -> b (h w) (p1 p2 c)'
        y = x.reshape(B, C, h, p, w, p).permute(0, 2, 4, 3, 5, 1).reshape(B, h * w, p * p * C)
        embed = level.fn[1]
        if isinstance(embed, nn.Linear):
            y = nnf.linear(y, embed.weight, embed.bias)
        mix = self.token_mixing_type
        for blk in level.fn[2:]:
            if mix == "original_tm":
                y = _token_block(blk[1], y.transpose(1, 2)).transpose(1, 2)  # b c (h w)
                y = _channel_block(blk[3], y)
                continue
            if mix == "ser_pm":
                co = Co // r
                # 'b (h w) (chw co) -> b (co w) (chw h)'
                t = y.reshape(B, h, w, r, co).permute(0, 4, 2, 3, 1).reshape(B, co * w, r * h)
                t = _permuted_block(blk[1], t, h, Co, r)
                # 'b (co w) (chw h) -> b (co h) (chw w)'
                t = t.reshape(B, co, w, r, h).permute(0, 1, 4, 3, 2).reshape(B, co * h, r * w)
                t = _permuted_block(blk[3], t, w, Co, r)
                # 'b (co h) (chw w) -> b (h w) (chw co)'
                y = t.reshape(B, co, h, r, w).permute(0, 2, 4, 3, 1).reshape(B, h * w, r * co)
            else:
                # 'b (h w) c -> b (c w) h'
                t = y.reshape(B, h, w, Co).permute(0, 3, 2, 1).reshape(B, Co * w, h)
                t = (_token_block(blk[1], t) if mix == "sep_ln_codim_tm"
                     else _sep_token_block(blk[1], t, Co, h))
                # 'b (c w) h -> b (c h) w'
                t = t.reshape(B, Co, w, h).permute(0, 1, 3, 2).reshape(B, Co * h, w)
                t = (_token_block(blk[3], t) if mix == "sep_ln_codim_tm"
                     else _sep_token_block(blk[3], t, Co, w))
                # 'b (c h) w -> b (h w) c'
                y = t.reshape(B, Co, h, w).permute(0, 2, 3, 1).reshape(B, h * w, Co)
            y = _channel_block(blk[5], y)
        # 'b (h w) c -> b c h w'
        return y.reshape(B, h, w, Co).permute(0, 3, 1, 2)

    def head_forward(self, head, x, is_last):
        """x NCHW → LN over the channels (+ spatial mean) (+ Linear)."""
        norm = head[1]
        y = nnf.layer_norm(x.permute(0, 2, 3, 1), norm.weight, norm.bias).permute(0, 3, 1, 2)
        if self.gap or not is_last:
            y = y.mean((2, 3))
        if not is_last:
            y = nnf.linear(y, head[4].weight, head[4].bias)
        return y

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        last = len(self.geo) - 1
        outputs = []
        for i, (level, g) in enumerate(zip(self.levels, self.geo)):
            x = self.level_forward(level, x, g)
            if self.shortcut:
                outputs.append(self.head_forward(self.heads[i], x, i == last))
        if not self.shortcut:
            out = self.head_forward(self.heads[0], x, True)
        else:
            out = outputs[-1]
            D = self.geo[-1]["out"]
            for b in outputs[-2::-1]:
                if self.gap:
                    out = b[:, :D] * out + b[:, D:]
                else:
                    out = b[:, :D].reshape(-1, D, 1, 1) * out + b[:, D:].reshape(-1, D, 1, 1)
        if not self.gap:
            out = out.reshape(out.shape[0], -1)
        return nnf.linear(out, self.classifier.weight, self.classifier.bias)


def RaftMLP(
    layers,
    in_channels=3,
    image_size=224,
    num_classes=1000,
    token_expansion_factor=2,
    channel_expansion_factor=4,
    dropout=0.0,
    token_mixing_type="ser_pm",
    shortcut=True,
    gap=False,
    drop_path_rate=0.0,
    seed=0,
    device="cuda",
):
    """RaftMLP; the JAX factory's signature, plus device (where the model is
    built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises). dropout is accepted and unused, as in the JAX package;
    drop_path_rate is accepted, and the port applies no drop-path (its
    training path is not ported yet)."""
    del dropout, drop_path_rate  # see the docstring
    return RaftMLPModel(
        layers=layers, in_channels=in_channels, image_size=image_size,
        num_classes=num_classes, token_expansion_factor=token_expansion_factor,
        channel_expansion_factor=channel_expansion_factor,
        token_mixing_type=token_mixing_type, shortcut=shortcut, gap=gap, seed=seed,
    ).place(device)
