"""ConvMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/conv_mlp.py``).

On NHWC activations:

- a tokenizer: three 3×3 conv-BN-ReLU (the first stride 2; no biases)
  and a 3×3 stride-2 max pool (padding 1);
- a conv stage of ``n_conv_blocks`` residual bottlenecks
  ``h = h + ReLU(BN(1×1(ReLU(BN(3×3(ReLU(BN(1×1(h)))))))))`` and a 3×3
  stride-2 downsample conv;
- MLP stages of blocks

      h = h + channel_mlp1(LN(h))
      h = connect(connect_norm(h))        # 3×3 depthwise, no bias; no residual
      h = h + channel_mlp2(norm2(h))

  with a 3×3 stride-2 conv (``downsample_mlp.downsample``) between stages;
- LayerNorm, the token mean and the head; with ``classifier_head=False``
  the model returns the final (B, H, W, C) map instead, as JAX does.

The 1×1 convs, the channel MLPs and the head run as dynamic W8A8 under
``config.int8_mode()``; every other conv is ``F.conv2d``. Drop-path (the
per-stage linspace 0–0.1) is not applied in training.

Parameter names are the torch reference's (``tokenizer.block.{0,1,3,4,6,7}``,
``conv_stages.conv_blocks.{j}.{0,1,3,4,6,7}``, ``conv_stages.downsample``,
``stages.{s}.blocks.{j}.{norm1,channel_mlp1.fc{1,2},connect_norm,connect,
norm2,channel_mlp2.fc{1,2}}``, ``stages.{s}.downsample_mlp.downsample``,
``norm``, ``head``). ``pretrained=True`` loads ``{arch}_imagenet.pth``
from ``$JITTOR_MLP_TPU_CKPT_DIR`` (``utils.checkpoint.load_pretrained``)
and never downloads.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model


def _init_state_dict(seed, *, depth, d_model, expansion_factor, channels, n_conv_blocks,
                     classifier_head, num_classes):
    """The JAX factory's SDBuilder calls, in its order."""
    b = SDBuilder(seed)
    c2 = channels // 2
    b.conv2d("tokenizer.block.0", 3, c2, 3, bias=False)
    b.batch_norm("tokenizer.block.1", c2)
    b.conv2d("tokenizer.block.3", c2, c2, 3, bias=False)
    b.batch_norm("tokenizer.block.4", c2)
    b.conv2d("tokenizer.block.6", c2, channels, 3, bias=False)
    b.batch_norm("tokenizer.block.7", channels)
    hid = d_model[0]
    for j in range(n_conv_blocks):
        pre = f"conv_stages.conv_blocks.{j}"
        b.conv2d(f"{pre}.0", channels, hid, 1, bias=False)
        b.batch_norm(f"{pre}.1", hid)
        b.conv2d(f"{pre}.3", hid, hid, 3, bias=False)
        b.batch_norm(f"{pre}.4", hid)
        b.conv2d(f"{pre}.6", hid, channels, 1, bias=False)
        b.batch_norm(f"{pre}.7", channels)
    b.conv2d("conv_stages.downsample", channels, d_model[0], 3)
    for si, d in enumerate(d_model):
        ff = int(d * expansion_factor[si])
        for j in range(depth[si]):
            pre = f"stages.{si}.blocks.{j}"
            b.layer_norm(f"{pre}.norm1", d)
            b.linear(f"{pre}.channel_mlp1.fc1", d, ff)
            b.linear(f"{pre}.channel_mlp1.fc2", ff, d)
            b.layer_norm(f"{pre}.norm2", d)
            b.conv2d(f"{pre}.connect", d, d, 3, groups=d, bias=False)
            b.layer_norm(f"{pre}.connect_norm", d)
            b.linear(f"{pre}.channel_mlp2.fc1", d, ff)
            b.linear(f"{pre}.channel_mlp2.fc2", ff, d)
        if si + 1 < len(d_model):
            b.conv2d(f"stages.{si}.downsample_mlp.downsample", d, d_model[si + 1], 3)
    if classifier_head:
        b.layer_norm("norm", d_model[-1])
        b.linear("head", d_model[-1], num_classes)
    return b.sd


def _conv_bn_relu(in_c, out_c, k, stride=1):
    return [nn.Conv2d(in_c, out_c, k, stride, k // 2, bias=False), nn.BatchNorm2d(out_c),
            nn.ReLU()]


class ConvTokenizer(nn.Module):
    def __init__(self, channels):
        super().__init__()
        c2 = channels // 2
        self.block = nn.Sequential(*_conv_bn_relu(3, c2, 3, 2), *_conv_bn_relu(c2, c2, 3),
                                   *_conv_bn_relu(c2, channels, 3), nn.MaxPool2d(3, 2, 1))


class ConvStage(nn.Module):
    def __init__(self, n_conv_blocks, channels, hidden, out):
        super().__init__()
        self.conv_blocks = nn.ModuleList(
            nn.Sequential(*_conv_bn_relu(channels, hidden, 1), *_conv_bn_relu(hidden, hidden, 3),
                          *_conv_bn_relu(hidden, channels, 1))
            for _ in range(n_conv_blocks))
        self.downsample = nn.Conv2d(channels, out, 3, 2, 1)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ConvMLPBlock(nn.Module):
    def __init__(self, dim, ff):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.channel_mlp1 = Mlp(dim, ff)
        self.norm2 = nn.LayerNorm(dim)
        self.connect = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=False)
        self.connect_norm = nn.LayerNorm(dim)
        self.channel_mlp2 = Mlp(dim, ff)


class ConvDownsample(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.downsample = nn.Conv2d(dim, out, 3, 2, 1)


class ConvMLPStage(nn.Module):
    def __init__(self, dim, ff, depth, out=None):
        super().__init__()
        self.blocks = nn.ModuleList(ConvMLPBlock(dim, ff) for _ in range(depth))
        if out is not None:
            self.downsample_mlp = ConvDownsample(dim, out)


def _mlp(m, x):
    return nnf.linear(nnf.gelu(nnf.linear(x, m.fc1.weight, m.fc1.bias)), m.fc2.weight,
                      m.fc2.bias)


def _ln(x, m):
    return nnf.layer_norm(x, m.weight, m.bias)


class ConvMLPModel(Model):
    name = "conv_mlp"

    def __init__(self, *, depth, d_model, expansion_factor, channels, n_conv_blocks,
                 classifier_head, num_classes, seed):
        super().__init__()
        n_stages = len(depth)
        with torch.device("meta"):  # weights come from SDBuilder below
            self.tokenizer = ConvTokenizer(channels)
            self.conv_stages = ConvStage(n_conv_blocks, channels, d_model[0], d_model[0])
            self.stages = nn.ModuleList(
                ConvMLPStage(d_model[si], int(d_model[si] * expansion_factor[si]), depth[si],
                             d_model[si + 1] if si + 1 < n_stages else None)
                for si in range(n_stages))
            if classifier_head:
                self.norm = nn.LayerNorm(d_model[-1])
                self.head = nn.Linear(d_model[-1], num_classes)
        self.classifier_head = classifier_head
        self._load_init(_init_state_dict(
            seed, depth=depth, d_model=d_model, expansion_factor=expansion_factor,
            channels=channels, n_conv_blocks=n_conv_blocks, classifier_head=classifier_head,
            num_classes=num_classes))

    def forward(self, x):
        """x: (B, 3, H, W) → logits (B, num_classes), or the final (B, H', W',
        C) map without the classifier head."""
        train = self.training
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        tk = self.tokenizer.block
        for ci, stride in ((0, 2), (3, 1), (6, 1)):
            x = nnf.conv2d(x, tk[ci].weight, stride=stride, padding=1)
            x = nnf.relu(nnf.bn(x, tk[ci + 1], train))
        x = nnf.max_pool2d(x, 3, 2, 1)
        for blk in self.conv_stages.conv_blocks:
            y = nnf.relu(nnf.bn(nnf.conv2d(x, blk[0].weight), blk[1], train))
            y = nnf.relu(nnf.bn(nnf.conv2d(y, blk[3].weight, padding=1), blk[4], train))
            x = x + nnf.relu(nnf.bn(nnf.conv2d(y, blk[6].weight), blk[7], train))
        ds = self.conv_stages.downsample
        x = nnf.conv2d(x, ds.weight, ds.bias, stride=2, padding=1)

        def block(blk, h):
            h = h + _mlp(blk.channel_mlp1, _ln(h, blk.norm1))
            h = nnf.conv2d(_ln(h, blk.connect_norm), blk.connect.weight, padding=1,
                           groups=h.shape[-1])
            return h + _mlp(blk.channel_mlp2, _ln(h, blk.norm2))

        for stage in self.stages:
            x = nnf.run_blocks(stage.blocks, x, block)
            if hasattr(stage, "downsample_mlp"):
                ds = stage.downsample_mlp.downsample
                x = nnf.conv2d(x, ds.weight, ds.bias, stride=2, padding=1)
        if not self.classifier_head:
            return x
        x = _ln(x.flatten(1, 2), self.norm).mean(1)
        return nnf.linear(x, self.head.weight, self.head.bias)


def ConvMLP(depth, d_model, expansion_factor, channels=64, n_conv_blocks=3,
            classifier_head=True, num_classes=1000, seed=0, device="cuda"):
    """ConvMLP with the JAX factory's signature, plus device (where the
    model is built, the card unless the caller asks for the CPU; with no
    card, "cuda" raises)."""
    return ConvMLPModel(
        depth=list(depth), d_model=list(d_model), expansion_factor=list(expansion_factor),
        channels=channels, n_conv_blocks=n_conv_blocks, classifier_head=classifier_head,
        num_classes=num_classes, seed=seed,
    ).place(device)


def _convmlp(arch, pretrained, classifier_head, **kwargs):
    model = ConvMLP(classifier_head=classifier_head, **kwargs)
    if pretrained:
        from ..utils.checkpoint import load_pretrained

        model.load_torch_state_dict(load_pretrained(f"{arch}_imagenet.pth"))
    return model


def convmlp_s(pretrained=False, progress=False, classifier_head=True, **kwargs):
    return _convmlp("convmlp_s", pretrained, classifier_head, depth=[2, 4, 2],
                    d_model=[128, 256, 512], expansion_factor=[2, 2, 2], channels=64,
                    n_conv_blocks=2, **kwargs)


def convmlp_m(pretrained=False, progress=False, classifier_head=True, **kwargs):
    return _convmlp("convmlp_m", pretrained, classifier_head, depth=[3, 6, 3],
                    d_model=[128, 256, 512], expansion_factor=[3, 3, 3], channels=64,
                    n_conv_blocks=3, **kwargs)


def convmlp_l(pretrained=False, progress=False, classifier_head=True, **kwargs):
    return _convmlp("convmlp_l", pretrained, classifier_head, depth=[4, 8, 3],
                    d_model=[192, 384, 768], expansion_factor=[3, 3, 3], channels=96,
                    n_conv_blocks=3, **kwargs)
