"""CycleMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/cycle_mlp.py``).

A hierarchy on NHWC activations: a 7×7 stride-4 Conv2d stem (padding 2),
stages of blocks

    h = h + attn(LN(h)) / skip_lam
    h = h + fc2(GELU(fc1(LN(h)))) / skip_lam

with a 3×3 stride-2 Conv2d (padding 1) after each stage that has a
transition, and at the end LayerNorm, a token mean and the head. ``attn``
mixes three branches, CycleFC ``sfc_h`` (kernel (1, 3): along W), CycleFC
``sfc_w`` (kernel (3, 1): along H) and the channel Linear ``mlp_c``, by a
softmax over the branches of ``reweight`` (fc1 → GELU → fc2) of their
spatial mean, then projects (``proj``). CycleFC is ``ops.deform.cycle_fc``.

Stages and transitions sit in one ``network`` list, as in the reference:
stage i's blocks in slot ``net_idx[i]``, its transition in the next. Each
CycleFC registers the reference's ``offset`` buffer (1, 2C, 1, 1); the
forward reads the offsets from the kernel shape, as the JAX package does,
so the buffer is not a parameter: it is not counted, trained or quantized.

CycleFC's products stay out of int8 (``jnp.matmul`` in JAX); ``mlp_c``,
``reweight``, ``proj``, the MLP and the head run as dynamic W8A8 under
``config.int8_mode()``; the stem and the transitions are ``F.conv2d``.
Drop-path (training) is not ported: the train-mode forward applies none.

Parameter names are the torch reference's (``patch_embed.proj``,
``network.{k}.{j}.{norm1,norm2,attn.{mlp_c,sfc_h,sfc_w,reweight.{fc1,fc2},
proj},mlp.{fc1,fc2}}``, ``network.{k}.proj``, ``norm``, ``head``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.deform import cycle_fc, cycle_offset


def _net_idx(layers, embed_dims, transitions):
    """The ``network`` slot of each stage's blocks: a transition after stage
    i takes the slot after its blocks."""
    idx, out = 0, []
    for i in range(len(layers)):
        out.append(idx)
        idx += 1 + _has_transition(i, layers, embed_dims, transitions)
    return out


def _has_transition(i, layers, embed_dims, transitions):
    return i < len(layers) - 1 and bool(transitions[i] or embed_dims[i] != embed_dims[i + 1])


def _init_state_dict(seed, *, layers, in_chans, embed_dims, transitions, mlp_ratios, qkv_bias,
                     num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    net_idx = _net_idx(layers, embed_dims, transitions)
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", in_chans, embed_dims[0], 7)
    for i in range(len(layers)):
        d = embed_dims[i]
        for j in range(layers[i]):
            pre = f"network.{net_idx[i]}.{j}"
            b.layer_norm(f"{pre}.norm1", d)
            b.linear(f"{pre}.attn.mlp_c", d, d, bias=qkv_bias)
            for sfc, (kh, kw) in (("sfc_h", (1, 3)), ("sfc_w", (3, 1))):
                b.conv2d(f"{pre}.attn.{sfc}", d, d, 1)
                b.param(f"{pre}.attn.{sfc}.offset", cycle_offset(d, kh, kw))
            b.linear(f"{pre}.attn.reweight.fc1", d, d // 4)
            b.linear(f"{pre}.attn.reweight.fc2", d // 4, d * 3)
            b.linear(f"{pre}.attn.proj", d, d)
            b.layer_norm(f"{pre}.norm2", d)
            b.linear(f"{pre}.mlp.fc1", d, int(d * mlp_ratios[i]))
            b.linear(f"{pre}.mlp.fc2", int(d * mlp_ratios[i]), d)
        if _has_transition(i, layers, embed_dims, transitions):
            b.conv2d(f"network.{net_idx[i] + 1}.proj", d, embed_dims[i + 1], 3)
    b.layer_norm("norm", embed_dims[-1])
    b.linear("head", embed_dims[-1], num_classes)
    return b.sd


def _linear(x, layer):
    return nnf.linear(x, layer.weight, layer.bias)


class CycleFC(nn.Module):
    def __init__(self, dim, kernel_size):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(dim, dim, 1, 1))
        self.bias = nn.Parameter(torch.empty(dim))
        self.register_buffer("offset", torch.empty(1, 2 * dim, 1, 1))

    def forward(self, x):
        return cycle_fc(x, self.weight, self.bias, self.kernel_size)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return _linear(nnf.gelu(_linear(x, self.fc1)), self.fc2)


class CycleMLPBranches(nn.Module):
    def __init__(self, dim, qkv_bias):
        super().__init__()
        self.mlp_c = nn.Linear(dim, dim, bias=qkv_bias)
        self.sfc_h = CycleFC(dim, (1, 3))
        self.sfc_w = CycleFC(dim, (3, 1))
        self.reweight = Mlp(dim, dim // 4, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        h, w, c = self.sfc_h(x), self.sfc_w(x), _linear(x, self.mlp_c)
        a = self.reweight((h + w + c).mean((1, 2)))
        a = nnf.softmax(a.reshape(B, C, 3).permute(2, 0, 1), dim=0)[:, :, None, None, :]
        return _linear(h * a[0] + w * a[1] + c * a[2], self.proj)


class CycleBlock(nn.Module):
    def __init__(self, dim, mlp_ratio, qkv_bias, skip_lam):
        super().__init__()
        self.skip_lam = skip_lam
        self.norm1 = nn.LayerNorm(dim)
        self.attn = CycleMLPBranches(dim, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, h):
        h = h + self.attn(nnf.layer_norm(h, self.norm1.weight, self.norm1.bias)) / self.skip_lam
        return h + self.mlp(nnf.layer_norm(h, self.norm2.weight, self.norm2.bias)) / self.skip_lam


class Downsample(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.proj = nn.Conv2d(dim, out, 3, 2, 1)

    def forward(self, x):
        return nnf.conv2d(x, self.proj.weight, self.proj.bias, stride=2, padding=1)


class PatchEmbed(nn.Module):
    def __init__(self, in_chans, dim):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, 7, 4, 2)


class CycleMLPModel(Model):
    name = "cycle_mlp"

    def __init__(self, *, layers, in_chans, num_classes, embed_dims, transitions, mlp_ratios,
                 skip_lam, qkv_bias, seed):
        super().__init__()
        net = []
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = PatchEmbed(in_chans, embed_dims[0])
            for i, depth in enumerate(layers):
                net.append(nn.ModuleList(
                    CycleBlock(embed_dims[i], mlp_ratios[i], qkv_bias, skip_lam)
                    for _ in range(depth)))
                if _has_transition(i, layers, embed_dims, transitions):
                    net.append(Downsample(embed_dims[i], embed_dims[i + 1]))
            self.network = nn.ModuleList(net)
            self.norm = nn.LayerNorm(embed_dims[-1])
            self.head = nn.Linear(embed_dims[-1], num_classes)
        self._load_init(_init_state_dict(
            seed, layers=layers, in_chans=in_chans, embed_dims=embed_dims,
            transitions=transitions, mlp_ratios=mlp_ratios, qkv_bias=qkv_bias,
            num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        pe = self.patch_embed.proj
        x = nnf.conv2d(x.permute(0, 2, 3, 1), pe.weight, pe.bias, stride=4, padding=2)
        for slot in self.network:
            if isinstance(slot, Downsample):
                x = slot(x)
            else:
                x = nnf.run_blocks(slot, x, lambda blk, h: blk(h))
        x = nnf.layer_norm(x, self.norm.weight, self.norm.bias).mean((1, 2))
        return _linear(x, self.head)


def CycleNet(
    layers,
    img_size=224,
    patch_size=4,
    in_chans=3,
    num_classes=1000,
    embed_dims=None,
    transitions=None,
    segment_dim=None,
    mlp_ratios=None,
    skip_lam=1.0,
    qkv_bias=False,
    drop_path_rate=0.0,
    fork_feat=False,
    seed=0,
    device="cuda",
    **kwargs,
):
    """CycleMLP's network; the JAX factory's signature, plus device (where
    the model is built, the card unless the caller asks for the CPU; with no
    card, "cuda" raises). As in JAX, the stem is always 7×7 stride 4, and
    img_size, patch_size, segment_dim, fork_feat and other keyword arguments
    are accepted and unused; drop_path_rate has no effect in eval, and
    training is not ported yet."""
    del img_size, patch_size, segment_dim, drop_path_rate, fork_feat, kwargs  # see above
    return CycleMLPModel(
        layers=list(layers), in_chans=in_chans, num_classes=num_classes,
        embed_dims=list(embed_dims), transitions=list(transitions),
        mlp_ratios=list(mlp_ratios), skip_lam=skip_lam, qkv_bias=qkv_bias, seed=seed,
    ).place(device)


def _factory(layers, mlp_ratios, embed_dims, **kwargs):
    return CycleNet(layers, embed_dims=embed_dims, patch_size=7,
                    transitions=[True, True, True, True], mlp_ratios=mlp_ratios, **kwargs)


def CycleMLP_B1(pretrained=False, **kwargs):
    return _factory([2, 2, 4, 2], [4, 4, 4, 4], [64, 128, 320, 512], **kwargs)


def CycleMLP_B2(pretrained=False, **kwargs):
    return _factory([2, 3, 10, 3], [4, 4, 4, 4], [64, 128, 320, 512], **kwargs)


def CycleMLP_B3(pretrained=False, **kwargs):
    return _factory([3, 4, 18, 3], [8, 8, 4, 4], [64, 128, 320, 512], **kwargs)


def CycleMLP_B4(pretrained=False, **kwargs):
    return _factory([3, 8, 27, 3], [8, 8, 4, 4], [64, 128, 320, 512], **kwargs)


def CycleMLP_B5(pretrained=False, **kwargs):
    return _factory([3, 4, 24, 3], [4, 4, 4, 4], [96, 192, 384, 768], **kwargs)
