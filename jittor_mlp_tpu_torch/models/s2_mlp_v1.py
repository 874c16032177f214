"""S2-MLP v1 in PyTorch (counterpart of ``jittor_mlp_tpu/models/s2_mlp_v1.py``).

Stages of a patchify Conv2d(k=s=patch) as one matmul on NHWC activations
and blocks of

    h = h + fc3(shift1(GELU(fc0(LN(h)))))
    h = h + fc3(GELU(fc0(LN(h))))

with ``ops.shift.spatial_shift1`` the four-way shift with functional-read
edges; then a spatial mean and a Linear head. Factories ``S2MLPv1_deep``
and ``S2MLPv1_wide`` fix the reference's two configurations.

Parameter names are the torch reference's (``stages.{s}.0``,
``stages.{s}.1.model.{j}.{0,1}.{norm,fn.0,fn.3}``, ``mlp_head.1``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.shift import spatial_shift1
from ..utils import pair


def _init_state_dict(seed, *, in_channels, patch_size, d_model, depth, expansion_factor,
                     num_classes):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    for si, d in enumerate(d_model):
        cin = in_channels if si == 0 else d_model[si - 1]
        b.conv2d(f"stages.{si}.0", cin, d, pair(patch_size[si]))
        for j in range(depth[si]):
            pre = f"stages.{si}.1.model.{j}"
            b.layer_norm(f"{pre}.0.norm", d)
            b.linear(f"{pre}.0.fn.0", d, d)
            b.linear(f"{pre}.0.fn.3", d, d)
            b.layer_norm(f"{pre}.1.norm", d)
            b.linear(f"{pre}.1.fn.0", d, d * expansion_factor[si])
            b.linear(f"{pre}.1.fn.3", d * expansion_factor[si], d)
    b.linear("mlp_head.1", d_model[-1], num_classes)
    return b.sd


def _linear(x, layer):
    return nnf.linear(x, layer.weight, layer.bias)


class PreNormResidual(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


def _mlp(dim, hidden):
    """fn.0 and fn.3 are the Linears; 1 is the GELU, 2 the shift or a
    dropout, 4 a dropout."""
    return nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
                         nn.Linear(hidden, dim), nn.Identity())


def ff_half(h, half):
    """h + fc3(GELU(fc0(LN(h)))): the channel half of an S2 block."""
    y = nnf.layer_norm(h, half.norm.weight, half.norm.bias)
    return h + _linear(nnf.gelu(_linear(y, half.fn[0])), half.fn[3])


def s2_block(blk, h):
    t = blk[0]
    y = nnf.layer_norm(h, t.norm.weight, t.norm.bias)
    y = spatial_shift1(nnf.gelu(_linear(y, t.fn[0])))
    return ff_half(h + _linear(y, t.fn[3]), blk[1])


class S2Stage(nn.Module):
    def __init__(self, dim, depth, expansion_factor):
        super().__init__()
        self.model = nn.ModuleList(
            nn.Sequential(PreNormResidual(dim, _mlp(dim, dim)),
                          PreNormResidual(dim, _mlp(dim, dim * expansion_factor)))
            for _ in range(depth))


class S2MLP(Model):
    """The S2-MLP stage stack shared by v1 and v2: ``block(blk, h)`` and
    ``stage(dim, depth, expansion)`` give the version's blocks."""

    def __init__(self, *, name, stage, block, init_sd, in_channels, patch_size, d_model,
                 depth, expansion_factor, num_classes, seed):
        super().__init__()
        if not len(patch_size) == len(d_model) == len(depth) == len(expansion_factor):
            raise ValueError("patch_size, d_model, depth and expansion_factor differ in length")
        self.name = name
        self.patch_sizes = [pair(p) for p in patch_size]
        self.block = block
        with torch.device("meta"):  # weights come from SDBuilder below
            self.stages = nn.ModuleList(
                nn.Sequential(
                    nn.Conv2d(in_channels if si == 0 else d_model[si - 1], d,
                              self.patch_sizes[si], stride=self.patch_sizes[si]),
                    stage(d, depth[si], expansion_factor[si]))
                for si, d in enumerate(d_model))
            self.mlp_head = nn.Sequential(nn.Identity(), nn.Linear(d_model[-1], num_classes))
        self._load_init(init_sd(
            seed, in_channels=in_channels, patch_size=patch_size, d_model=d_model,
            depth=depth, expansion_factor=expansion_factor, num_classes=num_classes))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        for stage, patch in zip(self.stages, self.patch_sizes):
            conv = stage[0]
            x = nnf.patch_embed(x, conv.weight, conv.bias, patch)
            x = nnf.run_blocks(stage[1].model, x, self.block)
        return _linear(x.mean((1, 2)), self.mlp_head[1])


def S2MLPv1(
    image_size=224,
    patch_size=[7, 2],
    in_channels=3,
    num_classes=1000,
    d_model=[192, 384],
    depth=[4, 14],
    expansion_factor=[3, 3],
    block_runner=None,
    seed=0,
    device="cuda",
):
    """S2-MLP v1; the JAX factory's signature, plus device (where the model
    is built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises). image_size is accepted, as in JAX: the patch
    embeddings follow the input. block_runner must be None: the parallel
    runners are not ported yet."""
    del image_size  # unused, as in the JAX factory
    if block_runner is not None:
        raise NotImplementedError("block_runner is not supported by the port yet")
    return S2MLP(
        name="s2_mlp_v1", stage=S2Stage, block=s2_block, init_sd=_init_state_dict,
        in_channels=in_channels, patch_size=list(patch_size), d_model=list(d_model),
        depth=list(depth), expansion_factor=list(expansion_factor), num_classes=num_classes,
        seed=seed,
    ).place(device)


def S2MLPv1_deep(num_classes: int = 1000, **kwargs):
    return S2MLPv1(image_size=224, patch_size=[16], d_model=[384], depth=[36],
                   num_classes=num_classes, expansion_factor=[4], **kwargs)


def S2MLPv1_wide(num_classes: int = 1000, **kwargs):
    return S2MLPv1(image_size=224, patch_size=[16], d_model=[768], depth=[12],
                   num_classes=num_classes, expansion_factor=[4], **kwargs)
