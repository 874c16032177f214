"""RepMLPNet in PyTorch (counterpart of ``jittor_mlp_tpu/models/repmlpnet.py``),
with locality injection (structural re-parameterization).

On NHWC activations: a bias-free stride-``patch_size`` conv stem with
BatchNorm and ReLU, stages of units

    h = h + RepMLPBlock(BN(h))
    h = h + BN(1×1(GELU(BN(1×1(BN(h))))))      # ffn_fc1, ffn_fc2: conv-BN

with a bias-free 2×2 stride-2 conv-BN-ReLU (``embeds.{i}``) between
stages, and at the end BatchNorm, a spatial mean and the head.

A RepMLPBlock works on the NCHW view, as the reference does: it splits the
map into h × w tiles, runs the per-shareset FC ``fc3`` (a grouped 1×1 conv
over each flattened tile, groups = S sharesets) as one batched product,
with its BatchNorm ``fc3_bn`` over the S channels of the
(N·hp·wp·C/S, S, h, w) partitions; adds the local branches ``repconv{k}``,
a k × k conv with groups=S on those partitions and its own BatchNorm over
S; puts the tiles back in the reference's order; and scales by the global
perceptron, sigmoid(fc2(ReLU(fc1(mean over H, W)))).

``locality_injection()`` folds, in place, each block's BatchNorms and
conv branches into ``fc3`` (``_fuse_bn``; ``_conv_to_fc``: the convs run
over identity tile images to give their dense FC), which leaves the deploy
form: ``fc3`` with a bias, no ``fc3_bn`` and no ``repconv{k}``, the module
tree of ``deploy=True``, whose checkpoints load into it strictly.

The global perceptron and the FFN's 1×1 convs run as dynamic W8A8 under
``config.int8_mode()``; ``fc3`` is a ``torch.einsum`` and, as in the JAX
package, never int8; the other convs are ``F.conv2d``. (The JAX package
runs the local branches of a whole-map tile as a C-channel depthwise conv
with the shareset kernel tiled C/S times and pools the BatchNorm
statistics over the replicas, a TPU lowering of the same function.)

Parameter names are the torch reference's (``conv_embedding.{conv,bn}``,
``stages.{i}.{j}.{prebn1,prebn2,repmlp_block.{gp.fc1,gp.fc2,fc3,fc3_bn,
repconv{k}.{conv,bn}},ffn_block.ffn_fc{1,2}.{conv,bn}}``,
``embeds.{i}.{conv,bn}``, ``head_norm``, ``head``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .. import config
from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..utils import pair


def _init_state_dict(seed, *, in_channels, num_class, patch_size, num_blocks, channels, hs, ws,
                     sharesets_nums, reparam_conv_k, globalperceptron_reduce, deploy):
    """The JAX factory's SDBuilder calls, in its order."""
    n_stages = len(num_blocks)
    b = SDBuilder(seed)
    b.conv2d("conv_embedding.conv", in_channels, channels[0], patch_size, bias=False)
    b.batch_norm("conv_embedding.bn", channels[0])
    for i in range(n_stages):
        C, S = channels[i], sharesets_nums[i]
        for j in range(num_blocks[i]):
            pre = f"stages.{i}.{j}"
            rb = f"{pre}.repmlp_block"
            b.conv2d(f"{rb}.gp.fc1", C, C // globalperceptron_reduce, 1)
            b.conv2d(f"{rb}.gp.fc2", C // globalperceptron_reduce, C, 1)
            b.conv2d(f"{rb}.fc3", S * hs[i] * ws[i], S * hs[i] * ws[i], 1, groups=S, bias=deploy)
            if not deploy:
                b.batch_norm(f"{rb}.fc3_bn", S)
                for k in reparam_conv_k or ():
                    b.conv2d(f"{rb}.repconv{k}.conv", S, S, k, groups=S, bias=False)
                    b.batch_norm(f"{rb}.repconv{k}.bn", S)
            b.conv2d(f"{pre}.ffn_block.ffn_fc1.conv", C, C * 4, 1, bias=False)
            b.batch_norm(f"{pre}.ffn_block.ffn_fc1.bn", C * 4)
            b.conv2d(f"{pre}.ffn_block.ffn_fc2.conv", C * 4, C, 1, bias=False)
            b.batch_norm(f"{pre}.ffn_block.ffn_fc2.bn", C)
            b.batch_norm(f"{pre}.prebn1", C)
            b.batch_norm(f"{pre}.prebn2", C)
        if i < n_stages - 1:
            b.conv2d(f"embeds.{i}.conv", C, channels[i + 1], 2, bias=False)
            b.batch_norm(f"embeds.{i}.bn", channels[i + 1])
    b.batch_norm("head_norm", channels[-1])
    b.linear("head", channels[-1], num_class)
    return b.sd


class ConvBN(nn.Module):
    def __init__(self, in_c, out_c, k, stride=1, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, k, stride, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_c)


def _conv_bn(m, x, train, stride=1, padding=0, groups=1, relu=False):
    """conv (no bias) then BatchNorm (then ReLU) on NHWC x."""
    y = nnf.bn(nnf.conv2d(x, m.conv.weight, stride=stride, padding=padding, groups=groups),
               m.bn, train)
    return nnf.relu(y) if relu else y


class GlobalPerceptron(nn.Module):
    def __init__(self, dim, reduce):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, dim // reduce, 1)
        self.fc2 = nn.Conv2d(dim // reduce, dim, 1)


class RepMLPBlock(nn.Module):
    def __init__(self, C, S, h, w, reparam_conv_k, reduce, deploy):
        super().__init__()
        self.S, self.h, self.w, self.deploy = S, h, w, deploy
        self.reparam_conv_k = tuple(reparam_conv_k or ())
        self.gp = GlobalPerceptron(C, reduce)
        self.fc3 = nn.Conv2d(S * h * w, S * h * w, 1, groups=S, bias=deploy)
        if not deploy:
            self.fc3_bn = nn.BatchNorm2d(S)
            for k in self.reparam_conv_k:
                self.add_module(f"repconv{k}", ConvBN(S, S, k, groups=S))


def repmlp_block(m, x, train):
    """The RepMLPBlock on NCHW x (N, C, H, W)."""
    N, C, H, W = x.shape
    S, h, w = m.S, m.h, m.w
    hp, wp = H // h, W // w
    g = nnf.relu(nnf.conv1x1(x.mean((2, 3)), m.gp.fc1.weight, m.gp.fc1.bias))
    g = nnf.sigmoid(nnf.conv1x1(g, m.gp.fc2.weight, m.gp.fc2.bias))
    parts = x.reshape(N, C, hp, h, wp, w).permute(0, 2, 4, 1, 3, 5)  # (N, hp, wp, C, h, w)
    wg = m.fc3.weight.reshape(S, h * w, h * w).to(x.dtype)
    out = torch.einsum("nsi,sji->nsj", parts.reshape(-1, S, h * w), wg)
    if m.deploy:
        out = out + m.fc3.bias.reshape(S, h * w).to(x.dtype)
    else:
        out = nnf.bn(out, m.fc3_bn, train, axis=1)
        conv_in = parts.reshape(-1, S, h, w).permute(0, 2, 3, 1)  # the partitions, NHWC view
        for k in m.reparam_conv_k:
            out = out + _conv_bn(getattr(m, f"repconv{k}"), conv_in, train, padding=k // 2,
                                 groups=S).permute(0, 3, 1, 2).reshape(out.shape)
    out = out.reshape(-1, hp, wp, S, h, w).permute(0, 3, 1, 4, 2, 5).reshape(N, C, H, W)
    return out * g[:, :, None, None]


class FFNBlock(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.ffn_fc1 = ConvBN(C, 4 * C, 1)
        self.ffn_fc2 = ConvBN(4 * C, C, 1)


class RepMLPNetUnit(nn.Module):
    def __init__(self, C, S, h, w, reparam_conv_k, reduce, deploy):
        super().__init__()
        self.repmlp_block = RepMLPBlock(C, S, h, w, reparam_conv_k, reduce, deploy)
        self.ffn_block = FFNBlock(C)
        self.prebn1 = nn.BatchNorm2d(C)
        self.prebn2 = nn.BatchNorm2d(C)


def _fuse_bn(weight, bn, eps=1e-5):
    """(weight, bias) of a conv (no bias) followed by ``bn`` in eval; the
    BatchNorm's width may divide the conv's output width (each of its
    channels then covers that many consecutive outputs)."""
    std = torch.sqrt(bn.running_var + eps)
    t = bn.weight / std
    bias = bn.bias - bn.running_mean * bn.weight / std
    if t.shape[0] != weight.shape[0]:
        rep = weight.shape[0] // t.shape[0]
        t, bias = t.repeat_interleave(rep), bias.repeat_interleave(rep)
    return weight * t[:, None, None, None], bias


def _conv_to_fc(kernel, bias, S, h, w):
    """The dense FC (S·h·w, h·w) and bias (S·h·w,) equal to the grouped
    conv ``kernel`` (S, 1, kh, kw) with ``bias`` on an h × w tile: the conv
    run over the h·w identity images, in float32 without TF32."""
    eye = torch.eye(h * w, dtype=kernel.dtype, device=kernel.device)
    images = eye.repeat(1, S).reshape(h * w, S, h, w)
    with config.parity_mode():
        out = F.conv2d(images, kernel, padding=(kernel.shape[2] // 2, kernel.shape[3] // 2),
                       groups=S)
    return out.reshape(h * w, S * h * w).t(), bias.repeat_interleave(h * w)


@torch.no_grad()
def fold_block(m):
    """Locality injection of one RepMLPBlock, in place: ``fc3`` takes the
    fused BatchNorm and conv branches and a bias; ``fc3_bn`` and the
    ``repconv{k}`` go."""
    fc_w, fc_b = _fuse_bn(m.fc3.weight, m.fc3_bn)
    if m.reparam_conv_k:
        ks = sorted(m.reparam_conv_k)
        largest = getattr(m, f"repconv{ks[-1]}")
        tk, tb = _fuse_bn(largest.conv.weight, largest.bn)
        for k in ks[:-1]:
            branch = getattr(m, f"repconv{k}")
            kk, kb = _fuse_bn(branch.conv.weight, branch.bn)
            p = (ks[-1] - k) // 2
            tk, tb = tk + F.pad(kk, (p, p, p, p)), tb + kb
        rep_w, rep_b = _conv_to_fc(tk, tb, m.S, m.h, m.w)
        fc_w, fc_b = rep_w.reshape(fc_w.shape) + fc_w, rep_b + fc_b
    fc3 = nn.Conv2d(m.fc3.in_channels, m.fc3.out_channels, 1, groups=m.S, device="meta")
    fc3.weight, fc3.bias = nn.Parameter(fc_w), nn.Parameter(fc_b)
    m.fc3 = fc3
    del m.fc3_bn
    for k in m.reparam_conv_k:
        delattr(m, f"repconv{k}")
    m.deploy = True


class RepMLPNetModel(Model):
    name = "repmlpnet"

    def __init__(self, *, in_channels, num_class, patch_size, num_blocks, channels, hs, ws,
                 sharesets_nums, reparam_conv_k, globalperceptron_reduce, use_checkpoint,
                 deploy, seed):
        super().__init__()
        n_stages = len(num_blocks)
        self.patch_size, self.use_checkpoint = pair(patch_size), use_checkpoint
        with torch.device("meta"):  # weights come from SDBuilder below
            self.conv_embedding = ConvBN(in_channels, channels[0], self.patch_size,
                                         self.patch_size)
            self.stages = nn.ModuleList(nn.ModuleList(
                RepMLPNetUnit(channels[i], sharesets_nums[i], hs[i], ws[i], reparam_conv_k,
                              globalperceptron_reduce, deploy) for _ in range(num_blocks[i]))
                for i in range(n_stages))
            self.embeds = nn.ModuleList(ConvBN(channels[i], channels[i + 1], 2, 2)
                                        for i in range(n_stages - 1))
            self.head_norm = nn.BatchNorm2d(channels[-1])
            self.head = nn.Linear(channels[-1], num_class)
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, num_class=num_class, patch_size=self.patch_size,
            num_blocks=num_blocks, channels=channels, hs=hs, ws=ws,
            sharesets_nums=sharesets_nums, reparam_conv_k=reparam_conv_k,
            globalperceptron_reduce=globalperceptron_reduce, deploy=deploy))

    @property
    def deploy(self):
        return self.stages[0][0].repmlp_block.deploy

    def locality_injection(self):
        """Fold every block's BatchNorms and conv branches into its ``fc3``,
        in place (the deploy form); returns the model."""
        if not self.deploy:
            for stage in self.stages:
                for unit in stage:
                    fold_block(unit.repmlp_block)
        return self

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_class)."""
        train = self.training
        x = _conv_bn(self.conv_embedding, x.permute(0, 2, 3, 1), train,  # NCHW → NHWC
                     stride=self.patch_size, relu=True)

        def block(unit, h):
            y = nnf.bn(h, unit.prebn1, train).permute(0, 3, 1, 2)  # NCHW view
            h = h + repmlp_block(unit.repmlp_block, y, train).permute(0, 2, 3, 1)
            ffn = unit.ffn_block
            y = nnf.gelu(_conv_bn(ffn.ffn_fc1, nnf.bn(h, unit.prebn2, train), train))
            return h + _conv_bn(ffn.ffn_fc2, y, train)

        for i, stage in enumerate(self.stages):
            x = nnf.run_blocks(stage, x, block, remat=self.use_checkpoint)
            if i < len(self.embeds):
                x = _conv_bn(self.embeds[i], x, train, stride=2, relu=True)
        x = nnf.bn(x, self.head_norm, train).mean((1, 2))
        return nnf.linear(x, self.head.weight, self.head.bias)


def RepMLPNet(
    in_channels=3,
    num_class=1000,
    patch_size=(4, 4),
    num_blocks=(2, 2, 6, 2),
    channels=(192, 384, 768, 1536),
    hs=(64, 32, 16, 8),
    ws=(64, 32, 16, 8),
    sharesets_nums=(4, 8, 16, 32),
    reparam_conv_k=(3,),
    globalperceptron_reduce=4,
    use_checkpoint=False,
    deploy=False,
    seed=0,
    device="cuda",
):
    """RepMLPNet with the JAX factory's signature, plus device (where the
    model is built, the card unless the caller asks for the CPU; with no
    card, "cuda" raises)."""
    return RepMLPNetModel(
        in_channels=in_channels, num_class=num_class, patch_size=patch_size,
        num_blocks=list(num_blocks), channels=list(channels), hs=list(hs), ws=list(ws),
        sharesets_nums=list(sharesets_nums), reparam_conv_k=reparam_conv_k,
        globalperceptron_reduce=globalperceptron_reduce, use_checkpoint=use_checkpoint,
        deploy=deploy, seed=seed,
    ).place(device)


def create_RepMLPNet_B224(deploy=False, **kwargs):
    return RepMLPNet(channels=(96, 192, 384, 768), hs=(56, 28, 14, 7), ws=(56, 28, 14, 7),
                     num_blocks=(2, 2, 12, 2), reparam_conv_k=(1, 3),
                     sharesets_nums=(1, 4, 32, 128), deploy=deploy, **kwargs)


def create_RepMLPNet_B256(deploy=False, **kwargs):
    return RepMLPNet(channels=(96, 192, 384, 768), hs=(64, 32, 16, 8), ws=(64, 32, 16, 8),
                     num_blocks=(2, 2, 12, 2), reparam_conv_k=(1, 3),
                     sharesets_nums=(1, 4, 32, 128), deploy=deploy, **kwargs)
