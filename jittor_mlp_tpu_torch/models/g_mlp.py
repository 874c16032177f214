"""gMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/g_mlp.py``).

Patchify Conv2d(k=s=patch) as one matmul, then ``depth`` blocks of
LN → Linear(d → 2·ffn) → GELU → spatial gating unit → Linear(ffn → d) +
residual; token mean → Linear head. The spatial gating unit splits the
channels in half (u, v), LayerNorms v, mixes it over the tokens with a
Conv1d(seq, seq, 1) whose bias starts at 1.0, and gates: u·v. Parameter
names are the torch reference's (``patcher.0``,
``model.{i}.{norm, channel_proj1, channel_proj2}``,
``model.{i}.sgu.{norm, spatial_proj}``, ``mlp_head.0``).

In bf16 eval, every block runs through ``ops.kernels.gmlp_block``'s
``fused_gmlp_block``, or under ``config.int8_mode()`` through
``ops.kernels.gmlp_block_int8``'s W8A8 ``fused_gmlp_block_int8`` (each the
CUDA kernel on a CUDA tensor, its plain twin on the CPU). bf16 training
runs ``fused_gmlp_block_trainable`` (the forward kernel, autograd of the
plain block backward), or the plain block under ``int8_mode()``; float32
takes the plain ``nnf`` block. The JAX gate's ``B % 2 == 0`` and
TPU-backend conditions belong to its TPU kernels and are dropped. Blocks
run through ``nnf.run_blocks`` (checkpointed under ``config.remat_mode()``).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import config
from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.kernels.gmlp_block import fused_gmlp_block, fused_gmlp_block_trainable
from ..ops.kernels.gmlp_block_int8 import fused_gmlp_block_int8
from ..utils import check_sizes, pair


def _init_state_dict(seed, *, in_channels, d_model, d_ffn, num_classes, patch_size,
                     num_patches, depth):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    b = SDBuilder(seed)
    b.conv2d("patcher.0", in_channels, d_model, patch_size)
    for i in range(depth):
        b.layer_norm(f"model.{i}.norm", d_model)
        b.linear(f"model.{i}.channel_proj1", d_model, d_ffn * 2)
        b.linear(f"model.{i}.channel_proj2", d_ffn, d_model)
        b.layer_norm(f"model.{i}.sgu.norm", d_ffn)
        b.conv1d(f"model.{i}.sgu.spatial_proj", num_patches, num_patches)
        b.const(f"model.{i}.sgu.spatial_proj.bias", (num_patches,), 1.0)
    b.linear("mlp_head.0", d_model, num_classes)
    return b.sd


class SpatialGatingUnit(nn.Module):
    def __init__(self, d_ffn, seq_len):
        super().__init__()
        self.norm = nn.LayerNorm(d_ffn)
        self.spatial_proj = nn.Conv1d(seq_len, seq_len, kernel_size=1)

    def forward(self, x):
        u, v = x.chunk(2, dim=-1)
        v = nnf.layer_norm(v, self.norm.weight, self.norm.bias)
        v = nnf.conv1d_token(v, self.spatial_proj.weight, self.spatial_proj.bias)
        return u * v


class gMLPBlock(nn.Module):
    def __init__(self, d_model, d_ffn, seq_len):
        super().__init__()
        self.norm = nn.LayerNorm(d_model)
        self.channel_proj1 = nn.Linear(d_model, d_ffn * 2)
        self.channel_proj2 = nn.Linear(d_ffn, d_model)
        self.sgu = SpatialGatingUnit(d_ffn, seq_len)

    def forward(self, x):
        """The plain block (the JAX package's g_mlp.py:99-106)."""
        y = nnf.layer_norm(x, self.norm.weight, self.norm.bias)
        y = nnf.gelu(nnf.linear(y, self.channel_proj1.weight, self.channel_proj1.bias))
        y = self.sgu(y)
        return x + nnf.linear(y, self.channel_proj2.weight, self.channel_proj2.bias)

    def fused_args(self):
        """(ln1w, ln1b, W1, b1, sgu_w, sgu_b, Wsp, bs, W2, b2) as the kernels
        take them: the Conv1d weight squeezed to (N, N)."""
        sgu = self.sgu
        return (self.norm.weight, self.norm.bias,
                self.channel_proj1.weight, self.channel_proj1.bias,
                sgu.norm.weight, sgu.norm.bias,
                sgu.spatial_proj.weight[:, :, 0], sgu.spatial_proj.bias,
                self.channel_proj2.weight, self.channel_proj2.bias)


class gMLP(Model):
    name = "g_mlp"

    def __init__(self, *, image_size, patch_size, in_channels, num_classes, d_model,
                 d_ffn, depth, use_pallas, seed):
        super().__init__()
        num_patches = check_sizes(image_size, patch_size)
        ph, _ = pair(patch_size)
        self.patch_size = ph
        self.num_patches = num_patches
        self.d_model = d_model
        self.use_pallas = use_pallas
        with torch.device("meta"):  # weights come from SDBuilder below
            self.patcher = nn.Sequential(nn.Conv2d(in_channels, d_model, ph, stride=ph))
            self.model = nn.ModuleList(
                gMLPBlock(d_model, d_ffn, num_patches) for _ in range(depth))
            self.mlp_head = nn.Sequential(nn.Linear(d_model, num_classes))
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, d_model=d_model, d_ffn=d_ffn,
            num_classes=num_classes, patch_size=ph, num_patches=num_patches, depth=depth,
        ))

    def uses_kernel(self, x):
        """The block-kernel gate: bf16 activations, except training under
        int8_mode()."""
        return (self.use_pallas and x.dtype == torch.bfloat16
                and not (self.training and config.int8_enabled()))

    def block_fn(self, x):
        """fn(block, x) that each block runs for activations like x."""
        if not self.uses_kernel(x):
            return lambda blk, x: blk(x)
        if self.training:
            kernel = fused_gmlp_block_trainable
        else:
            kernel = fused_gmlp_block_int8 if config.int8_enabled() else fused_gmlp_block
        return lambda blk, x: kernel(x, *(a.to(x.dtype) for a in blk.fused_args()))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        conv = self.patcher[0]
        x = nnf.patch_embed(x, conv.weight, conv.bias, self.patch_size)
        x = x.reshape(x.shape[0], self.num_patches, self.d_model)
        x = nnf.run_blocks(self.model, x, self.block_fn(x))
        x = nnf.global_avg_pool_tokens(x)
        head = self.mlp_head[0]
        return nnf.linear(x, head.weight, head.bias)


def gMLPForImageClassification(
    image_size=256,
    patch_size=16,
    in_channels=3,
    num_classes=1000,
    d_model=256,
    d_ffn=1536,
    depth=30,
    use_pallas=True,
    block_runner=None,
    seed=0,
    device="cuda",
):
    """use_pallas: keeps the JAX factory's name; True runs bf16 blocks
    through the hand-written gMLP-block kernels (W8A8 under int8_mode in
    eval; in training the forward kernel with the plain block's backward).
    block_runner must be None: the parallel runners are not ported yet.
    device: where the model is built, the card unless the caller asks for
    the CPU; with no card, "cuda" raises."""
    if block_runner is not None:
        raise NotImplementedError("block_runner is not supported by the port yet")
    return gMLP(
        image_size=image_size, patch_size=patch_size, in_channels=in_channels,
        num_classes=num_classes, d_model=d_model, d_ffn=d_ffn, depth=depth,
        use_pallas=use_pallas, seed=seed,
    ).place(device)
