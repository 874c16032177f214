"""WaveMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/wave_mlp.py``).

On NHWC activations: a 7×7 stride-4 conv stem (padding 2) and BatchNorm,
stages of BN-prenorm residual blocks

    h = h + PATM(BN(h))
    h = h + fc2(GELU(fc1(BN(h))))            # 1×1 convs

with a 3×3 stride-2 conv (padding 1) and BatchNorm between stages, and at
the end BatchNorm, a spatial mean and the head. PATM, the phase-aware
token mixer:

- the phases θ_h, θ_w = ReLU(BN(1×1 conv(x))), the amplitudes fc_h(x),
  fc_w(x) and the channel path c = fc_c(x), all 1×1 convs;
- h = tfc_h([fc_h(x)·cos θ_h ⧺ fc_h(x)·sin θ_h]), a (1, 7) conv from the
  2C concat channels to C with groups=C (group g reads concat channels
  2g and 2g + 1, torch's grouping), and w = tfc_w(...) likewise, (7, 1);
- softmax weights over the three branches from the reweight MLP on the
  spatial mean of h + w + c, and proj(h·a₀ + w·a₁ + c·a₂).

The token-fuse convs are ``F.conv2d`` with groups=C on the concat, the
reference's op. (The JAX package splits each into its even and odd channel
streams and sums two depthwise convs, a TPU lowering.) Every 1×1 conv and
the head run as dynamic W8A8 under ``config.int8_mode()``; the token-fuse
convs, the stem and the downsamples never do.

Parameter names are the torch reference's (``patch_embed.{proj,norm}``,
``network.{2s}.{j}.{norm1,attn.{fc_h,fc_w,fc_c,tfc_h,tfc_w,reweight.fc{1,2},
theta_{h,w}_conv.{0,1},proj},norm2,mlp.fc{1,2}}``,
``network.{2s+1}.{proj,norm}``, ``norm``, ``head``). ``pretrained=`` takes
a local checkpoint path (``utils.checkpoint.load_torch_checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from .morph_mlp import ConvBN, Mlp

wavemlp_settings = {
    "T": [[2, 2, 4, 2], [4, 4, 4, 4]],
    "S": [[2, 3, 10, 3], [4, 4, 4, 4]],
    "M": [[3, 4, 18, 3], [8, 8, 4, 4]],
}
EMBED_DIMS = [64, 128, 320, 512]


def _init_state_dict(seed, *, layers, mlp_ratios, num_classes):
    """The JAX factory's SDBuilder calls, in its order."""
    n_stages = len(layers)
    embed_dims = EMBED_DIMS
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", 3, embed_dims[0], 7)
    b.batch_norm("patch_embed.norm", embed_dims[0])
    for si in range(n_stages):
        d = embed_dims[si]
        for j in range(layers[si]):
            pre = f"network.{2 * si}.{j}"
            b.batch_norm(f"{pre}.norm1", d)
            for fc in ("fc_h", "fc_w", "fc_c", "proj"):
                b.conv2d(f"{pre}.attn.{fc}", d, d, 1)
            b.conv2d(f"{pre}.attn.tfc_h", 2 * d, d, (1, 7), groups=d, bias=False)
            b.conv2d(f"{pre}.attn.tfc_w", 2 * d, d, (7, 1), groups=d, bias=False)
            b.conv2d(f"{pre}.attn.reweight.fc1", d, d // 4, 1)
            b.conv2d(f"{pre}.attn.reweight.fc2", d // 4, d * 3, 1)
            b.conv2d(f"{pre}.attn.theta_h_conv.0", d, d, 1)
            b.batch_norm(f"{pre}.attn.theta_h_conv.1", d)
            b.conv2d(f"{pre}.attn.theta_w_conv.0", d, d, 1)
            b.batch_norm(f"{pre}.attn.theta_w_conv.1", d)
            b.batch_norm(f"{pre}.norm2", d)
            b.conv2d(f"{pre}.mlp.fc1", d, int(d * mlp_ratios[si]), 1)
            b.conv2d(f"{pre}.mlp.fc2", int(d * mlp_ratios[si]), d, 1)
        if si + 1 < n_stages:
            b.conv2d(f"network.{2 * si + 1}.proj", d, embed_dims[si + 1], 3)
            b.batch_norm(f"network.{2 * si + 1}.norm", embed_dims[si + 1])
    b.batch_norm("norm", embed_dims[-1])
    b.linear("head", embed_dims[-1], num_classes)
    return b.sd


class PATM(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc_h = nn.Conv2d(dim, dim, 1)
        self.fc_w = nn.Conv2d(dim, dim, 1)
        self.fc_c = nn.Conv2d(dim, dim, 1)
        self.tfc_h = nn.Conv2d(2 * dim, dim, (1, 7), 1, (0, 3), groups=dim, bias=False)
        self.tfc_w = nn.Conv2d(2 * dim, dim, (7, 1), 1, (3, 0), groups=dim, bias=False)
        self.reweight = Mlp(dim, dim // 4, dim * 3)
        self.proj = nn.Conv2d(dim, dim, 1)
        self.theta_h_conv = nn.Sequential(nn.Conv2d(dim, dim, 1), nn.BatchNorm2d(dim), nn.ReLU())
        self.theta_w_conv = nn.Sequential(nn.Conv2d(dim, dim, 1), nn.BatchNorm2d(dim), nn.ReLU())


class WaveBlock(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim)
        self.attn = PATM(dim)
        self.norm2 = nn.BatchNorm2d(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


def _conv11(x, conv):
    return nnf.conv1x1(x, conv.weight, conv.bias)


def token_fuse(x2, conv, padding):
    """``conv`` (2C → C, groups=C, no bias) on the concat x2 (B, H, W, 2C):
    output channel g from concat channels 2g and 2g + 1."""
    return nnf.conv2d(x2, conv.weight, padding=padding, groups=conv.out_channels)


def patm(m, x, train):
    """The phase-aware token mixer on x (B, H, W, C)."""
    th = nnf.relu(nnf.bn(_conv11(x, m.theta_h_conv[0]), m.theta_h_conv[1], train))
    tw = nnf.relu(nnf.bn(_conv11(x, m.theta_w_conv[0]), m.theta_w_conv[1], train))
    x_h, x_w, c = _conv11(x, m.fc_h), _conv11(x, m.fc_w), _conv11(x, m.fc_c)
    h = token_fuse(torch.cat([x_h * torch.cos(th), x_h * torch.sin(th)], -1), m.tfc_h, (0, 3))
    w = token_fuse(torch.cat([x_w * torch.cos(tw), x_w * torch.sin(tw)], -1), m.tfc_w, (3, 0))
    a = (h + w + c).mean((1, 2))[:, None, None, :]
    a = _conv11(nnf.gelu(_conv11(a, m.reweight.fc1)), m.reweight.fc2)[:, 0, 0, :]
    B, C = a.shape[0], x.shape[-1]
    a = nnf.softmax(a.reshape(B, C, 3).permute(2, 0, 1), 0)[:, :, None, None, :]  # (3, B, 1, 1, C)
    return _conv11(h * a[0] + w * a[1] + c * a[2], m.proj)


class WaveMLPModel(Model):
    name = "wave_mlp"

    def __init__(self, *, model_name, num_classes, seed):
        super().__init__()
        if model_name not in wavemlp_settings:
            raise ValueError(f"model_name {model_name!r} not in {sorted(wavemlp_settings)}")
        layers, mlp_ratios = wavemlp_settings[model_name]
        n_stages = len(layers)
        embed_dims = EMBED_DIMS
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = ConvBN(3, embed_dims[0], 7, 4, 2)
            net = []
            for si in range(n_stages):
                net.append(nn.ModuleList(WaveBlock(embed_dims[si], mlp_ratios[si])
                                         for _ in range(layers[si])))
                if si + 1 < n_stages:
                    net.append(ConvBN(embed_dims[si], embed_dims[si + 1], 3, 2, 1))
            self.network = nn.ModuleList(net)
            self.norm = nn.BatchNorm2d(embed_dims[-1])
            self.head = nn.Linear(embed_dims[-1], num_classes)
        self._load_init(_init_state_dict(seed, layers=layers, mlp_ratios=mlp_ratios,
                                         num_classes=num_classes))

    def forward(self, x):
        """x: (B, 3, H, W) → logits (B, num_classes)."""
        train = self.training

        def block(blk, h):
            h = h + patm(blk.attn, nnf.bn(h, blk.norm1, train), train)
            y = nnf.bn(h, blk.norm2, train)
            return h + _conv11(nnf.gelu(_conv11(y, blk.mlp.fc1)), blk.mlp.fc2)

        x = self.patch_embed(x.permute(0, 2, 3, 1), train)  # NCHW → NHWC
        for i, slot in enumerate(self.network):
            x = nnf.run_blocks(slot, x, block) if i % 2 == 0 else slot(x, train)
        x = nnf.bn(x, self.norm, train).mean((1, 2))
        return nnf.linear(x, self.head.weight, self.head.bias)


def WaveMLP(model_name="T", pretrained=None, num_classes=1000, seed=0, device="cuda",
            **kwargs):
    """WaveMLP-``model_name`` (T, S, M). The JAX factory's signature, plus
    device (where the model is built, the card unless the caller asks for
    the CPU; with no card, "cuda" raises). ``pretrained``: a local
    checkpoint path; other keyword arguments are accepted and unused, as
    in the JAX factory."""
    model = WaveMLPModel(model_name=model_name, num_classes=num_classes, seed=seed).place(device)
    if pretrained:
        from ..utils.checkpoint import load_torch_checkpoint

        model.load_torch_state_dict(load_torch_checkpoint(pretrained))
    return model
