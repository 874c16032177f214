"""S2-MLP v2 in PyTorch (counterpart of ``jittor_mlp_tpu/models/s2_mlp_v2.py``).

The stages of S2-MLP v1 (``s2_mlp_v1.S2MLP``) with the S2 attention block:
a Linear widens the channels ×3, the three chunks go through
``spatial_shift1``, ``spatial_shift2`` and the identity, ViP's
``split_attention`` fuses them, and a Linear projects back; then the
channel FF. Both halves are pre-norm residuals.

Parameter names are the torch reference's (``stages.{s}.0``,
``stages.{s}.1.model.{j}.0.{norm,fn.mlp1,fn.mlp2}``,
``...0.fn.split_attention.{mlp1,mlp2}``, ``...1.{norm,fn.0,fn.3}``,
``mlp_head.1``).
"""

from __future__ import annotations

from torch import nn

from ..core import nnf
from ..core.init import SDBuilder
from ..ops.shift import spatial_shift1, spatial_shift2
from ..utils import pair
from .s2_mlp_v1 import S2MLP, PreNormResidual, _linear, _mlp, ff_half
from .vip import SplitAttention, split_attention


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
            b.linear(f"{pre}.0.fn.mlp1", d, d * 3)
            b.linear(f"{pre}.0.fn.mlp2", d, d)
            b.linear(f"{pre}.0.fn.split_attention.mlp1", d, d, bias=False)
            b.linear(f"{pre}.0.fn.split_attention.mlp2", d, d * 3, bias=False)
            b.layer_norm(f"{pre}.1.norm", d)
            b.linear(f"{pre}.1.fn.0", d, d * expansion_factor[si])
            b.linear(f"{pre}.1.fn.3", d * expansion_factor[si], d)
    b.linear("mlp_head.1", d_model[-1], num_classes)
    return b.sd


class S2Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.mlp1 = nn.Linear(dim, dim * 3)
        self.mlp2 = nn.Linear(dim, dim)
        self.split_attention = SplitAttention(dim)


class S2Stage(nn.Module):
    def __init__(self, dim, depth, expansion_factor):
        super().__init__()
        self.model = nn.ModuleList(
            nn.Sequential(PreNormResidual(dim, S2Attention(dim)),
                          PreNormResidual(dim, _mlp(dim, dim * expansion_factor)))
            for _ in range(depth))


def s2_attention_block(blk, h):
    t = blk[0]
    c = h.shape[-1]
    y = _linear(nnf.layer_norm(h, t.norm.weight, t.norm.bias), t.fn.mlp1)
    branches = [spatial_shift1(y[..., :c]), spatial_shift2(y[..., c:2 * c]), y[..., 2 * c:]]
    y = _linear(split_attention(t.fn.split_attention, branches), t.fn.mlp2)
    return ff_half(h + y, blk[1])


def S2MLPv2(
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
    """S2-MLP v2; the JAX factory's signature, plus device (where the model
    is built, the card unless the caller asks for the CPU; with no card,
    "cuda" raises). image_size is accepted, as in JAX: the patch
    embeddings follow the input. block_runner: optional fn(fn, blocks, x)
    running each stage's block stack (``parallel.pipeline_runner``)."""
    del image_size  # unused, as in the JAX factory
    return S2MLP(
        name="s2_mlp_v2", stage=S2Stage, block=s2_attention_block, init_sd=_init_state_dict,
        in_channels=in_channels, patch_size=list(patch_size), d_model=list(d_model),
        depth=list(depth), expansion_factor=list(expansion_factor), num_classes=num_classes,
        seed=seed,
    ).place(device).with_runner(block_runner)
