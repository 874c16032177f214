"""Sequencer2D in PyTorch (counterpart of ``jittor_mlp_tpu/models/sequencer.py``).

On NHWC activations, stages of a patchify Conv2d(k=s=patch) as one matmul
(patch sizes 7, 2, 1, 1) and blocks of

    h = h + fc(BiLSTM_v(y) ⧺ BiLSTM_h(y)),   y = LN(h)
    h = h + fn.3(GELU(fn.0(LN(h))))

then a spatial mean and a Linear head. The vertical BiLSTM runs over the
B·W columns (H steps each), the horizontal one over the B·H rows (W steps
each), both through ``ops/lstm.bilstm`` (cuDNN's RNN on the card), and
their (…, 2H) outputs are concatenated, vertical first. LayerNorm eps is
1e-5.

Under ``config.int8_mode()`` ``fc``, the channel FF, the patch embeddings
and the head run as dynamic W8A8; the LSTMs stay in the compute dtype, as
the JAX package's ``einsum``/``matmul`` do.

``sequencer_settings`` holds S, M and L as (depths, embed dims, hidden
dims, expansion factor); a caller may add one.

Parameter names are the torch reference's (``stages.{s}.0``,
``stages.{s}.1.model.{j}.0.{norm,fn.0.rnn_v,fn.0.rnn_h,fn.0.fc}``,
``...1.{norm,fn.0,fn.3}``, ``mlp_head.1``). ``pretrained=`` takes a local
checkpoint path (``utils.checkpoint.load_torch_checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.lstm import LSTM, bilstm

sequencer_settings = {
    "S": [[4, 3, 8, 3], [192, 384, 384, 384], [48, 96, 96, 96], 3],
    "M": [[4, 3, 14, 3], [192, 384, 384, 384], [48, 96, 96, 96], 3],
    "L": [[8, 8, 16, 4], [192, 384, 384, 384], [48, 96, 96, 96], 3],
}
PATCH_SIZES = [7, 2, 1, 1]


def _init_state_dict(seed, *, depth, embed_dims, hidden_dims, expansion_factor, in_channels,
                     num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    for si in range(len(depth)):
        cin = in_channels if si == 0 else embed_dims[si - 1]
        d, hd = embed_dims[si], hidden_dims[si]
        b.conv2d(f"stages.{si}.0", cin, d, PATCH_SIZES[si])
        for j in range(depth[si]):
            pre = f"stages.{si}.1.model.{j}"
            b.layer_norm(f"{pre}.0.norm", d)
            b.lstm(f"{pre}.0.fn.0.rnn_v", d, hd)
            b.lstm(f"{pre}.0.fn.0.rnn_h", d, hd)
            b.linear(f"{pre}.0.fn.0.fc", 4 * hd, d)
            b.layer_norm(f"{pre}.1.norm", d)
            b.linear(f"{pre}.1.fn.0", d, d * expansion_factor)
            b.linear(f"{pre}.1.fn.3", d * expansion_factor, d)
    b.linear("mlp_head.1", embed_dims[-1], num_classes)
    return b.sd


class BiLSTM2D(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.rnn_v = LSTM(dim, hidden)
        self.rnn_h = LSTM(dim, hidden)
        self.fc = nn.Linear(4 * hidden, dim)

    def forward(self, x):
        """x (B, H, W, C) → (B, H, W, C)."""
        B, H, W, C = x.shape
        v = bilstm(self.rnn_v, x.transpose(1, 2).reshape(B * W, H, C))
        v = v.reshape(B, W, H, -1).transpose(1, 2)
        h = bilstm(self.rnn_h, x.reshape(B * H, W, C)).reshape(B, H, W, -1)
        return nnf.linear(torch.cat([v, h], -1), self.fc.weight, self.fc.bias)


class PreNormResidual(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


class Stage(nn.Module):
    def __init__(self, dim, depth, hidden, expansion_factor):
        super().__init__()
        inner = dim * expansion_factor
        # fn.1 is the GELU, fn.2 and fn.4 dropouts
        self.model = nn.ModuleList(
            nn.Sequential(
                PreNormResidual(dim, nn.Sequential(BiLSTM2D(dim, hidden))),
                PreNormResidual(dim, nn.Sequential(nn.Linear(dim, inner), nn.GELU(),
                                                   nn.Identity(), nn.Linear(inner, dim),
                                                   nn.Identity())))
            for _ in range(depth))


def sequencer_block(blk, h):
    t, c = blk[0], blk[1]
    h = h + t.fn[0](nnf.layer_norm(h, t.norm.weight, t.norm.bias))
    y = nnf.layer_norm(h, c.norm.weight, c.norm.bias)
    y = nnf.gelu(nnf.linear(y, c.fn[0].weight, c.fn[0].bias))
    return h + nnf.linear(y, c.fn[3].weight, c.fn[3].bias)


class Sequencer2DModel(Model):
    name = "sequencer"

    def __init__(self, *, model_name, in_channels, num_classes, seed):
        super().__init__()
        if model_name not in sequencer_settings:
            raise ValueError(f"model_name {model_name!r} not in {sorted(sequencer_settings)}")
        depth, embed_dims, hidden_dims, expansion_factor = sequencer_settings[model_name]
        with torch.device("meta"):  # weights come from SDBuilder below
            self.stages = nn.ModuleList(
                nn.Sequential(
                    nn.Conv2d(in_channels if si == 0 else embed_dims[si - 1], d,
                              PATCH_SIZES[si], stride=PATCH_SIZES[si]),
                    Stage(d, depth[si], hidden_dims[si], expansion_factor))
                for si, d in enumerate(embed_dims))
            self.mlp_head = nn.Sequential(nn.Identity(), nn.Linear(embed_dims[-1], num_classes))
        self._load_init(_init_state_dict(
            seed, depth=depth, embed_dims=embed_dims, hidden_dims=hidden_dims,
            expansion_factor=expansion_factor, in_channels=in_channels,
            num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        for stage, patch in zip(self.stages, PATCH_SIZES):
            conv = stage[0]
            x = nnf.patch_embed(x, conv.weight, conv.bias, patch)
            x = nnf.run_blocks(stage[1].model, x, sequencer_block)
        head = self.mlp_head[1]
        return nnf.linear(x.mean((1, 2)), head.weight, head.bias)


def Sequencer2D(model_name="M", pretrained=None, num_classes=1000, in_channels=3, seed=0,
                device="cuda", **kwargs):
    """Sequencer2D-``model_name`` (S, M, L). The JAX factory's signature,
    plus device (where the model is built, the card unless the caller asks
    for the CPU; with no card, "cuda" raises). ``pretrained``: a local
    checkpoint path; other keyword arguments are accepted and unused, as in
    the JAX factory."""
    model = Sequencer2DModel(model_name=model_name, in_channels=in_channels,
                             num_classes=num_classes, seed=seed).place(device)
    if pretrained:
        from ..utils.checkpoint import load_torch_checkpoint

        model.load_torch_state_dict(load_torch_checkpoint(pretrained))
    return model
