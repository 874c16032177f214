"""ResMLP in PyTorch (counterpart of ``jittor_mlp_tpu/models/res_mlp.py``).

Patchify Conv2d(k=s=patch) as one matmul, then ``depth`` blocks of
pre-Affine → Conv1d k=1 token mix × γ1 (residual) → post-Affine → channel
FF × γ2 (residual); token mean → Linear head. γ starts at 0.1 for depth
≤ 18, 1e-5 for depth ≤ 24, else 1e-6. The reference builds a final Affine
(``affine``) but its forward never applies it: the parameters are kept for
state-dict compatibility and the executed behaviour is reproduced.
Parameter names are the torch reference's (``patcher.0``,
``model.{i}.{pre_affine,post_affine}.{alpha,beta}``, ``model.{i}.token_mix``,
``model.{i}.ff.net.{0,3}``, ``model.{i}.gamma_{1,2}``, ``affine``,
``mlp_head.0``).

In bf16 eval, every block runs through ``ops.kernels.resmlp_block``'s
``fused_resmlp_block``, or under ``config.int8_mode()`` through
``ops.kernels.resmlp_block_int8``'s W8A8 ``fused_resmlp_block_int8`` (each
the CUDA kernel on a CUDA tensor, its plain twin on the CPU). bf16 training
runs ``fused_resmlp_block_trainable`` (the forward kernel, autograd of the
plain block backward), or the plain block under ``int8_mode()``; float32
takes the plain ``nnf`` block. Blocks run through ``nnf.run_blocks``
(checkpointed under ``config.remat_mode()``).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import config
from ..core import nnf
from ..core.init import SDBuilder
from ..core.model import Model
from ..ops.kernels.resmlp_block import fused_resmlp_block, fused_resmlp_block_trainable
from ..ops.kernels.resmlp_block_int8 import fused_resmlp_block_int8
from ..utils import check_sizes, pair
from .mlp_mixer import FeedForward


def _init_values(depth):
    """LayerScale init by depth (the reference's res_mlp.py:38-43)."""
    if depth <= 18:
        return 0.1
    if depth <= 24:
        return 1e-5
    return 1e-6


def _init_state_dict(seed, *, in_channels, d_model, num_classes, patch_size,
                     num_patches, depth, expansion_factor):
    """The JAX factory's SDBuilder calls, in its order: the same seed gives
    the same weights bit for bit."""
    gamma = _init_values(depth)
    b = SDBuilder(seed)
    b.conv2d("patcher.0", in_channels, d_model, patch_size)
    for i in range(depth):
        b.ones(f"model.{i}.pre_affine.alpha", (1, 1, d_model))
        b.zeros(f"model.{i}.pre_affine.beta", (1, 1, d_model))
        b.conv1d(f"model.{i}.token_mix", num_patches, num_patches)
        b.linear(f"model.{i}.ff.net.0", d_model, d_model * expansion_factor)
        b.linear(f"model.{i}.ff.net.3", d_model * expansion_factor, d_model)
        b.ones(f"model.{i}.post_affine.alpha", (1, 1, d_model))
        b.zeros(f"model.{i}.post_affine.beta", (1, 1, d_model))
        b.const(f"model.{i}.gamma_1", (d_model,), gamma)
        b.const(f"model.{i}.gamma_2", (d_model,), gamma)
    b.ones("affine.alpha", (1, 1, d_model))
    b.zeros("affine.beta", (1, 1, d_model))
    b.linear("mlp_head.0", d_model, num_classes)
    return b.sd


class Aff(nn.Module):
    """ResMLP's affine "norm": x * alpha + beta, alpha/beta (1, 1, dim)."""

    def __init__(self, dim):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1, 1, dim))
        self.beta = nn.Parameter(torch.empty(1, 1, dim))

    def forward(self, x):
        return nnf.affine(x, self.alpha, self.beta)


class ResBlock(nn.Module):
    def __init__(self, dim, num_patches, hidden):
        super().__init__()
        self.pre_affine = Aff(dim)
        self.token_mix = nn.Conv1d(num_patches, num_patches, kernel_size=1)
        self.ff = FeedForward(nn.Linear, dim, hidden)
        self.post_affine = Aff(dim)
        self.gamma_1 = nn.Parameter(torch.empty(dim))
        self.gamma_2 = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        """The plain block (the JAX package's res_mlp.py:103-110)."""
        net = self.ff.net
        h = self.pre_affine(x)
        h = h + self.gamma_1 * nnf.conv1d_token(h, self.token_mix.weight, self.token_mix.bias)
        h = self.post_affine(h)
        y = nnf.gelu(nnf.linear(h, net[0].weight, net[0].bias))
        y = nnf.linear(y, net[3].weight, net[3].bias)
        return h + self.gamma_2 * y

    def fused_args(self):
        """(α1, β1, γ1, Wt, bt, α2, β2, γ2, W1, c1, W2, c2) as the kernels
        take them: affines flattened to (D,), the Conv1d weight (N, N)."""
        net = self.ff.net
        return (self.pre_affine.alpha.reshape(-1), self.pre_affine.beta.reshape(-1),
                self.gamma_1, self.token_mix.weight[:, :, 0], self.token_mix.bias,
                self.post_affine.alpha.reshape(-1), self.post_affine.beta.reshape(-1),
                self.gamma_2, net[0].weight, net[0].bias, net[3].weight, net[3].bias)


class ResMLP(Model):
    name = "res_mlp"

    def __init__(self, *, in_channels, d_model, num_classes, patch_size,
                 image_size, depth, expansion_factor, use_pallas, seed):
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
                ResBlock(d_model, num_patches, d_model * expansion_factor)
                for _ in range(depth))
            self.affine = Aff(d_model)
            self.mlp_head = nn.Sequential(nn.Linear(d_model, num_classes))
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, d_model=d_model, num_classes=num_classes,
            patch_size=ph, num_patches=num_patches, depth=depth,
            expansion_factor=expansion_factor,
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
            kernel = fused_resmlp_block_trainable
        else:
            kernel = fused_resmlp_block_int8 if config.int8_enabled() else fused_resmlp_block
        return lambda blk, x: kernel(x, *(a.to(x.dtype) for a in blk.fused_args()))

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        conv = self.patcher[0]
        x = nnf.patch_embed(x, conv.weight, conv.bias, self.patch_size)
        x = x.reshape(x.shape[0], self.num_patches, self.d_model)
        x = nnf.run_blocks(self.model, x, self.block_fn(x))
        # self.affine is built but not applied, as in the reference
        x = nnf.global_avg_pool_tokens(x)
        head = self.mlp_head[0]
        return nnf.linear(x, head.weight, head.bias)


def ResMLPForImageClassification(
    in_channels=3,
    d_model=384,
    num_classes=1000,
    patch_size=16,
    image_size=224,
    depth=12,
    expansion_factor=4,
    use_pallas=True,
    block_runner=None,
    seed=0,
    device="cuda",
):
    """use_pallas: keeps the JAX factory's name; True runs bf16 blocks
    through the hand-written ResMLP-block kernels (W8A8 under int8_mode in
    eval; in training the forward kernel with the plain block's backward).
    block_runner must be None: the parallel runners are not ported yet.
    device: where the model is built, the card unless the caller asks for
    the CPU; with no card, "cuda" raises."""
    if block_runner is not None:
        raise NotImplementedError("block_runner is not supported by the port yet")
    return ResMLP(
        in_channels=in_channels, d_model=d_model, num_classes=num_classes,
        patch_size=patch_size, image_size=image_size, depth=depth,
        expansion_factor=expansion_factor, use_pallas=use_pallas, seed=seed,
    ).place(device)
