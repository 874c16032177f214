"""MLP-Mixer in PyTorch (counterpart of ``jittor_mlp_tpu/models/mlp_mixer.py``).

Patchify Conv2d(k=s=patch) as one matmul, then ``depth`` blocks of
PreNormResidual(token FF as Conv1d k=1 over patches) + PreNormResidual(channel
FF as Linear), final LayerNorm → token mean → Linear head. Layout is
(B, N, D) channels-last throughout; parameter names are the torch
reference's (``patcher.0``, ``model.{i}.0.norm``, ``model.{i}.0.fn.net.{0,3}``,
``model.{i}.1.…``, ``active``, ``mlp_head.0``).

With bf16 activations every block runs in hand-written kernels (the CUDA
kernel on a CUDA tensor, its plain twin on the CPU), as the JAX gate picks
its Pallas kernels:
- eval: ``ops.kernels.mixer_block``'s ``fused_mixer_block``, or under
  ``config.int8_mode()`` the W8A8 ``fused_mixer_block_int8``;
- training: ``fused_mixer_block_trainable`` (kernel forward, autograd of the
  plain block backward), or under ``config.pallas_bwd``
  ``ops.kernels.mixer_block_bwd.fused_mixer_block_train`` (kernel forward
  and backward); under ``int8_mode()`` the plain block (a train step
  refuses int8).
float32 takes the plain ``nnf`` block, whose dense ops go int8 under
``int8_mode()`` as in the JAX package. The JAX gate's ``B % 2 == 0`` and
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
from ..ops.kernels.mixer_block import fused_mixer_block, fused_mixer_block_trainable
from ..ops.kernels.mixer_block_bwd import fused_mixer_block_train
from ..ops.kernels.mixer_block_int8 import fused_mixer_block_int8
from ..utils import check_sizes, pair


def _init_state_dict(seed, *, in_channels, d_model, num_classes, patch_size,
                     num_patches, depth, expansion_factor, token_dim):
    b = SDBuilder(seed)
    b.conv2d("patcher.0", in_channels, d_model, patch_size)
    for i in range(depth):
        b.layer_norm(f"model.{i}.0.norm", d_model)
        b.conv1d(f"model.{i}.0.fn.net.0", num_patches, token_dim)
        b.conv1d(f"model.{i}.0.fn.net.3", token_dim, num_patches)
        b.layer_norm(f"model.{i}.1.norm", d_model)
        b.linear(f"model.{i}.1.fn.net.0", d_model, d_model * expansion_factor)
        b.linear(f"model.{i}.1.fn.net.3", d_model * expansion_factor, d_model)
    b.layer_norm("active", d_model)
    b.linear("mlp_head.0", d_model, num_classes)
    return b.sd


class FeedForward(nn.Module):
    """Parameter holder with the reference's names: net.0 and net.3 are the
    two dense layers (Conv1d k=1 for the token mix, Linear for the channel
    mix); net.1 is the GELU and net.2/net.4 the (zero-rate) dropouts."""

    def __init__(self, dense, dim, hidden):
        super().__init__()
        self.net = nn.Sequential(dense(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 dense(hidden, dim), nn.Dropout(0.0))


class PreNormResidual(nn.Module):
    """x + FF(LN(x)); ``token=True`` mixes over the token axis."""

    def __init__(self, dim, fn, token):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn
        self.token = token

    def forward(self, x):
        net = self.fn.net
        y = nnf.layer_norm(x, self.norm.weight, self.norm.bias)
        dense = nnf.conv1d_token if self.token else nnf.linear
        y = dense(y, net[0].weight, net[0].bias)
        y = nnf.gelu(y)
        y = dense(y, net[3].weight, net[3].bias)
        return x + y

    def fused_args(self):
        """(norm weight, norm bias, W1, b1, W2, b2) as the kernel takes them."""
        net = self.fn.net
        w1, w2 = net[0].weight, net[3].weight
        if self.token:  # Conv1d (out, in, 1) → (out, in)
            w1, w2 = w1[:, :, 0], w2[:, :, 0]
        return (self.norm.weight, self.norm.bias, w1, net[0].bias,
                w2, net[3].bias)


class MLPMixer(Model):
    name = "mlp_mixer"

    def __init__(self, *, in_channels, d_model, num_classes, patch_size,
                 image_size, depth, expansion_factor, token_dim, use_pallas,
                 seed):
        super().__init__()
        num_patches = check_sizes(image_size, patch_size)
        ph, _ = pair(patch_size)
        if token_dim is None:
            token_dim = num_patches * expansion_factor
        self.patch_size = ph
        self.num_patches = num_patches
        self.d_model = d_model
        self.use_pallas = use_pallas
        hidden = d_model * expansion_factor

        def token_dense(i, o):
            return nn.Conv1d(i, o, kernel_size=1)

        with torch.device("meta"):  # weights come from SDBuilder below
            self.patcher = nn.Sequential(
                nn.Conv2d(in_channels, d_model, ph, stride=ph))
            self.model = nn.ModuleList(
                nn.Sequential(
                    PreNormResidual(d_model, FeedForward(token_dense, num_patches,
                                                         token_dim), token=True),
                    PreNormResidual(d_model, FeedForward(nn.Linear, d_model, hidden),
                                    token=False),
                )
                for _ in range(depth)
            )
            self.active = nn.LayerNorm(d_model)
            self.mlp_head = nn.Sequential(nn.Linear(d_model, num_classes))
        self._load_init(_init_state_dict(
            seed, in_channels=in_channels, d_model=d_model,
            num_classes=num_classes, patch_size=ph, num_patches=num_patches,
            depth=depth, expansion_factor=expansion_factor, token_dim=token_dim,
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
        if not self.training:
            kernel = fused_mixer_block_int8 if config.int8_enabled() else fused_mixer_block
        elif config.pallas_bwd:
            kernel = fused_mixer_block_train
        else:
            kernel = fused_mixer_block_trainable

        def fn(blk, x):
            tok, chan = blk
            return kernel(x, *(a.to(x.dtype) for a in (*tok.fused_args(), *chan.fused_args())))

        return fn

    def forward(self, x):
        """x: (B, C, H, W) → logits (B, num_classes)."""
        x = x.permute(0, 2, 3, 1)  # NCHW → NHWC
        conv = self.patcher[0]
        x = nnf.patch_embed(x, conv.weight, conv.bias, self.patch_size)
        x = x.reshape(x.shape[0], self.num_patches, self.d_model)
        x = nnf.run_blocks(self.model, x, self.block_fn(x), runner=self.block_runner)
        x = nnf.layer_norm(x, self.active.weight, self.active.bias)
        x = nnf.global_avg_pool_tokens(x)
        head = self.mlp_head[0]
        return nnf.linear(x, head.weight, head.bias)


def MLPMixerForImageClassification(
    in_channels=3,
    d_model=512,
    num_classes=1000,
    patch_size=16,
    image_size=224,
    depth=12,
    expansion_factor=4,
    token_dim=None,
    use_pallas=True,
    block_runner=None,
    seed=0,
    device="cuda",
):
    """token_dim: hidden width of the token-mixing FF. Defaults to
    num_patches*expansion_factor; the paper's Mixer-B/16 uses 384.

    use_pallas: keeps the JAX factory's name; True runs bf16 blocks
    through the hand-written mixer-block kernels (W8A8 under int8_mode in
    eval; in training the forward kernel, and under config.pallas_bwd the
    backward kernels too).
    block_runner: optional fn(fn, blocks, x) running the block stack
    (``parallel.pipeline_runner``, ``parallel.token_parallel_runner``);
    under a pipeline each stage runs its blocks through the same kernels.
    device: where the model is built, the card unless the caller asks for
    the CPU; with no card, "cuda" raises."""
    return MLPMixer(
        in_channels=in_channels, d_model=d_model, num_classes=num_classes,
        patch_size=patch_size, image_size=image_size, depth=depth,
        expansion_factor=expansion_factor, token_dim=token_dim,
        use_pallas=use_pallas, seed=seed,
    ).place(device).with_runner(block_runner)
