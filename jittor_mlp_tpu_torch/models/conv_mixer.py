"""ConvMixer in PyTorch (counterpart of ``jittor_mlp_tpu/models/conv_mixer.py``).

On NHWC activations: a stride-``patch_size`` conv stem (padding
patch_size // 2), GELU and BatchNorm, then ``depth`` blocks of

    h = h + BN(GELU(depthwise_conv(h)))      # k × k, XLA "same" padding
    h = BN(GELU(pointwise_conv(h)))          # no residual around it

and a spatial mean and the head. The pointwise conv is the dense product
(dynamic W8A8 under ``config.int8_mode()``); the stem and the depthwise
convs are ``F.conv2d``.

Parameter names are the torch reference's (``embedding.{0,2}``,
``blocks.{i}.0.fn.{0,2}``, ``blocks.{i}.{1,3}``, ``classifier.2``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model


def _init_state_dict(seed, *, dim, depth, kernel_size, patch_size, n_classes):
    """The JAX factory's SDBuilder calls, in its order."""
    b = SDBuilder(seed)
    b.conv2d("embedding.0", 3, dim, patch_size)
    b.batch_norm("embedding.2", dim)
    for i in range(depth):
        b.conv2d(f"blocks.{i}.0.fn.0", dim, dim, kernel_size, groups=dim)
        b.batch_norm(f"blocks.{i}.0.fn.2", dim)
        b.conv2d(f"blocks.{i}.1", dim, dim, 1)
        b.batch_norm(f"blocks.{i}.3", dim)
    b.linear("classifier.2", dim, n_classes)
    return b.sd


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn


class ConvMixerModel(Model):
    name = "conv_mixer"

    def __init__(self, *, dim, depth, kernel_size, patch_size, n_classes, seed):
        super().__init__()
        self.patch_size = patch_size
        with torch.device("meta"):  # weights come from SDBuilder below
            self.embedding = nn.Sequential(
                nn.Conv2d(3, dim, patch_size, patch_size, patch_size // 2), nn.GELU(),
                nn.BatchNorm2d(dim))
            self.blocks = nn.ModuleList(nn.Sequential(
                Residual(nn.Sequential(nn.Conv2d(dim, dim, kernel_size, groups=dim,
                                                 padding="same"),
                                       nn.GELU(), nn.BatchNorm2d(dim))),
                nn.Conv2d(dim, dim, 1), nn.GELU(), nn.BatchNorm2d(dim)) for _ in range(depth))
            self.classifier = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                                            nn.Linear(dim, n_classes))
        self._load_init(_init_state_dict(seed, dim=dim, depth=depth, kernel_size=kernel_size,
                                         patch_size=patch_size, n_classes=n_classes))

    def forward(self, x):
        """x: (B, 3, H, W) → logits (B, n_classes)."""
        train = self.training
        conv, norm = self.embedding[0], self.embedding[2]
        x = nnf.conv2d(x.permute(0, 2, 3, 1), conv.weight, conv.bias,  # NCHW → NHWC
                       stride=self.patch_size, padding=self.patch_size // 2)
        x = nnf.bn(nnf.gelu(x), norm, train)
        dim = x.shape[-1]

        def block(blk, h):
            dw, dw_norm = blk[0].fn[0], blk[0].fn[2]
            y = nnf.conv2d(h, dw.weight, dw.bias, padding="same", groups=dim)
            h = h + nnf.bn(nnf.gelu(y), dw_norm, train)
            y = nnf.conv2d(h, blk[1].weight, blk[1].bias)
            return nnf.bn(nnf.gelu(y), blk[3], train)

        x = nnf.run_blocks(self.blocks, x, block)
        head = self.classifier[2]
        return nnf.linear(x.mean((1, 2)), head.weight, head.bias)


def ConvMixer(dim, depth, kernel_size=9, patch_size=7, n_classes=1000, seed=0, device="cuda"):
    """ConvMixer-``dim``/``depth``. The JAX factory's signature, plus device
    (where the model is built, the card unless the caller asks for the CPU;
    with no card, "cuda" raises)."""
    return ConvMixerModel(dim=dim, depth=depth, kernel_size=kernel_size,
                          patch_size=patch_size, n_classes=n_classes, seed=seed).place(device)
