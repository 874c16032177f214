"""MorphMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/morph_mlp.py``).

On NHWC activations: a 7×7 stride-4 conv stem (padding 2) and BatchNorm,
stages of BN-prenorm residual blocks

    h = h + morph_fc(BN(h))
    h = h + fc2(GELU(fc1(BN(h))))            # 1×1 convs

with a 3×3 stride-2 conv (padding 1) and BatchNorm between stages, and at
the end BatchNorm, a spatial mean and the head. ``morph_fc`` sums three
1×1 convs: ``fc_c`` on the input, ``fc_h`` on the input zero-padded
symmetrically on H up to a multiple of the stage's chunk length L (when
H % L > 0) and cropped back, and ``fc_w`` likewise on W. The reference's
chunk rearranges are defined and never applied, so the pad and crop are
the whole of it; the port does them literally, as the JAX package does.

Every 1×1 conv and the head run as dynamic W8A8 under
``config.int8_mode()``; the stem and the downsamples are ``F.conv2d``.
Drop-path (``stoch_drop``) is not applied in training.

Parameter names are the torch reference's (``patch_embed.{proj,norm}``,
``network.{2s}.{j}.{norm1,attn.fc_{h,w,c},norm2,mlp.fc{1,2}}``,
``network.{2s+1}.{proj,norm}``, ``norm``, ``head``). ``pretrained=`` takes
a local checkpoint path (``utils.checkpoint.load_torch_checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model

morphmlp_settings = {
    "T": [[3, 4, 7, 3], [4, 4, 4, 4], [84, 168, 336, 588], [14, 28, 28, 49], [0.1, 0.1, 0.1, 0.1]],
    "S": [[3, 4, 9, 3], [4, 4, 4, 4], [112, 224, 392, 784], [14, 28, 28, 49], [0.1, 0.1, 0.1, 0.1]],
    "B": [[4, 6, 15, 4], [4, 4, 4, 4], [112, 224, 392, 784], [14, 28, 28, 49], [0.3, 0.3, 0.3, 0.3]],
    "L": [[4, 8, 18, 6], [4, 4, 4, 4], [112, 224, 392, 784], [14, 28, 28, 49], [0.4, 0.4, 0.4, 0.4]],
}


def _init_state_dict(seed, *, layers, mlp_ratios, embed_dims, num_classes):
    """The JAX factory's SDBuilder calls, in its order."""
    n_stages = len(layers)
    b = SDBuilder(seed)
    b.conv2d("patch_embed.proj", 3, embed_dims[0], 7)
    b.batch_norm("patch_embed.norm", embed_dims[0])
    for si in range(n_stages):
        d = embed_dims[si]
        for j in range(layers[si]):
            pre = f"network.{2 * si}.{j}"
            b.batch_norm(f"{pre}.norm1", d)
            for fc in ("fc_h", "fc_w", "fc_c"):
                b.conv2d(f"{pre}.attn.{fc}", d, d, 1)
            b.batch_norm(f"{pre}.norm2", d)
            b.conv2d(f"{pre}.mlp.fc1", d, int(d * mlp_ratios[si]), 1)
            b.conv2d(f"{pre}.mlp.fc2", int(d * mlp_ratios[si]), d, 1)
        if si + 1 < n_stages:
            b.conv2d(f"network.{2 * si + 1}.proj", d, embed_dims[si + 1], 3)
            b.batch_norm(f"network.{2 * si + 1}.norm", embed_dims[si + 1])
    b.batch_norm("norm", embed_dims[-1])
    b.linear("head", embed_dims[-1], num_classes)
    return b.sd


class ConvBN(nn.Module):
    """``proj`` then ``norm``: the stem and the downsamples."""

    def __init__(self, in_c, out_c, k, stride, padding):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.proj = nn.Conv2d(in_c, out_c, k, stride, padding)
        self.norm = nn.BatchNorm2d(out_c)

    def forward(self, x, train):
        x = nnf.conv2d(x, self.proj.weight, self.proj.bias, stride=self.stride,
                       padding=self.padding)
        return nnf.bn(x, self.norm, train)


class MorphFC(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc_h = nn.Conv2d(dim, dim, 1)
        self.fc_w = nn.Conv2d(dim, dim, 1)
        self.fc_c = nn.Conv2d(dim, dim, 1)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out=None):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, out or dim, 1)


class MorphBlock(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim)
        self.attn = MorphFC(dim)
        self.norm2 = nn.BatchNorm2d(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))


def morph_fc(m, x, L):
    """fc_h + fc_w + fc_c of x (B, H, W, C), fc_h on H zero-padded to a
    multiple of L and cropped back, fc_w likewise on W."""
    H, W = x.shape[1:3]
    x_h = x_w = x
    pt = pl = 0
    if H % L:
        pt = (L - H % L) // 2
        x_h = F.pad(x, (0, 0, 0, 0, pt, L - H % L - pt))
    if W % L:
        pl = (L - W % L) // 2
        x_w = F.pad(x, (0, 0, pl, L - W % L - pl))
    x_h = nnf.conv1x1(x_h, m.fc_h.weight, m.fc_h.bias)[:, pt:pt + H]
    x_w = nnf.conv1x1(x_w, m.fc_w.weight, m.fc_w.bias)[:, :, pl:pl + W]
    return x_h + x_w + nnf.conv1x1(x, m.fc_c.weight, m.fc_c.bias)


class MorphMLPModel(Model):
    name = "morph_mlp"

    def __init__(self, *, model_name, num_classes, seed):
        super().__init__()
        if model_name not in morphmlp_settings:
            raise ValueError(f"model_name {model_name!r} not in {sorted(morphmlp_settings)}")
        layers, mlp_ratios, embed_dims, chunk_len, _stoch_drop = morphmlp_settings[model_name]
        self.chunk_len = list(chunk_len)
        n_stages = len(layers)
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patch_embed = ConvBN(3, embed_dims[0], 7, 4, 2)
            net = []
            for si in range(n_stages):
                net.append(nn.ModuleList(MorphBlock(embed_dims[si], mlp_ratios[si])
                                         for _ in range(layers[si])))
                if si + 1 < n_stages:
                    net.append(ConvBN(embed_dims[si], embed_dims[si + 1], 3, 2, 1))
            self.network = nn.ModuleList(net)
            self.norm = nn.BatchNorm2d(embed_dims[-1])
            self.head = nn.Linear(embed_dims[-1], num_classes)
        self._load_init(_init_state_dict(seed, layers=layers, mlp_ratios=mlp_ratios,
                                         embed_dims=embed_dims, num_classes=num_classes))

    def forward(self, x):
        """x: (B, 3, H, W) → logits (B, num_classes)."""
        train = self.training
        x = self.patch_embed(x.permute(0, 2, 3, 1), train)  # NCHW → NHWC
        for si in range(len(self.chunk_len)):
            L = self.chunk_len[si]

            def block(blk, h, L=L):
                h = h + morph_fc(blk.attn, nnf.bn(h, blk.norm1, train), L)
                y = nnf.bn(h, blk.norm2, train)
                y = nnf.conv1x1(nnf.gelu(nnf.conv1x1(y, blk.mlp.fc1.weight, blk.mlp.fc1.bias)),
                                blk.mlp.fc2.weight, blk.mlp.fc2.bias)
                return h + y

            x = nnf.run_blocks(self.network[2 * si], x, block)
            if 2 * si + 1 < len(self.network):
                x = self.network[2 * si + 1](x, train)
        x = nnf.bn(x, self.norm, train).mean((1, 2))
        return nnf.linear(x, self.head.weight, self.head.bias)


def MorphMLP(model_name="T", pretrained=None, num_classes=1000, seed=0, device="cuda",
             **kwargs):
    """MorphMLP-``model_name`` (T, S, B, L). The JAX factory's signature,
    plus device (where the model is built, the card unless the caller asks
    for the CPU; with no card, "cuda" raises). ``pretrained``: a local
    checkpoint path; other keyword arguments are accepted and unused, as
    in the JAX factory."""
    model = MorphMLPModel(model_name=model_name, num_classes=num_classes,
                          seed=seed).place(device)
    if pretrained:
        from ..utils.checkpoint import load_torch_checkpoint

        model.load_torch_state_dict(load_torch_checkpoint(pretrained))
    return model
