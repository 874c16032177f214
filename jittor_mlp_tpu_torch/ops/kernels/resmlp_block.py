"""ResMLP block forward: the hand-written CUDA kernel, its plain twin, the wrapper.

Replaces ``jittor_mlp_tpu/ops/pallas/resmlp_block.py::fused_resmlp_block``.
The kernel source is ``csrc/resmlp_block.cu`` (its header says what bounds
it on an H100 and what the design does about that). For x (B, N, D):

    h   = dt(x·α1 + β1)                              f32 affine, rounded
    h2  = (h + γ1·(Wt·h + bt))·α2 + β2               f32, per image
    c   = dt(act(dt(h2)·W1ᵀ + c1))
    out = dt(h2 + γ2·(c·W2ᵀ + c2))                   h2 in f32

with dt the input dtype, act the tanh-form GELU for bf16 (the kernel
evaluates it as x·σ(2u) on the special-function unit, within the bound
``csrc/common.cuh`` states; the twins keep ``torch.tanh``) and the exact
one for float32, and the weights in their torch layouts: wt (N, N) (the token
mix's Conv1d squeezed), w1 (F, D), w2 (D, F); affines and gammas (D,).
This follows the TPU *kernel*, which keeps h2 in f32 for the last residual;
the reference's plain block rounds it first.

- ``resmlp_block_ref``: plain PyTorch with the kernel's rounding points, its
  three products the core's twin ``ops.products.gemm_bf16_ref`` on the
  kernel's layouts (Wt in rows of Np = round_up(N, 8) read as its first N
  columns, shared by every image, and h an N-major B operand an entry an
  image; h2 and c K-major over all B·N rows).
- ``fused_resmlp_block``: the op ``jittor_mlp_tpu_torch::fused_resmlp_block``
  (``_op.register``; ``OP``): a CPU tensor goes to the twin; a CUDA bf16
  contiguous tensor launches the kernel; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel;
  ``mode_launches()``: the ``wgmma`` core's launches by mode (two on the
  handoff schedule a launch, the token product and FF1; one plain, FF2);
  ``routes()``: its products on the bf16 ``wgmma`` core (``sm90``) and on
  the WMMA core (``wmma``), three a launch: the ``wgmma`` core where TMA
  can load the operands (the token product and FF1 need D, FF2 needs F, a
  multiple of 8), else WMMA.
- ``resmlp_block_plain``: the JAX ``_plain_resmlp_block`` (products and bias
  adds in the input dtype), whose autograd is the training backward.
- ``fused_resmlp_block_trainable``: forward ``fused_resmlp_block``, backward
  autograd of ``resmlp_block_plain``.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ..products import gemm_bf16_ref
from ._build import Library
from ._op import register, tensor_args
from .mixer_block import (KernelForwardPlainBackward, check_block_input, check_weights,
                          require_bf16_contiguous)

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("resmlp_block", ["resmlp_block.cu"], {"resmlp_block_bf16": (15, 4)},
               error="resmlp_error_string", workspace={"resmlp_block_bf16_workspace": 4},
               queries={"resmlp_mode_launches": 1}, routes="resmlp_gemm_products")
# the wgmma core's launch modes this library runs: the token product and FF1 on the
# handoff schedule, FF2 on the plain mode
MODES = {"plain": 0, "handoff": 4}


def block_dims(x, weights):
    """Check the block's 12 weights against x (B, N, D) in shape and device;
    return (B, N, D, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got shape {tuple(x.shape)}")
    B, N, D = x.shape
    F = weights[8].shape[0]
    want = [(D,), (D,), (D,), (N, N), (N,), (D,), (D,), (D,), (F, D), (F,), (D, F), (D,)]
    names = ["alpha1", "beta1", "gamma1", "wt", "bt", "alpha2", "beta2", "gamma2",
             "w1", "c1", "w2", "c2"]
    check_weights(x, weights, names, want)
    return B, N, D, F


def resmlp_block_ref(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """Plain PyTorch twin of the kernel, rounding where the kernel rounds.
    On CUDA the float32 matmuls need TF32 off (PyTorch's default for
    matmuls) to match."""
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    B, N, D = x.shape
    h = (x.float() * a1.float() + b1.float()).to(dt)
    wt_rows = torch.nn.functional.pad(wt, (0, -N % 8))  # the kernel's copy: rows of Np
    t = gemm_bf16_ref(wt_rows[:, :N], h, b_mn=True) + bt.float()[:, None]
    h2 = h.float() + g1.float() * t
    h2 = (h2 * a2.float() + b2.float()).reshape(B * N, D)
    c = act(gemm_bf16_ref(h2.to(dt), w1)[0] + c1.float()).to(dt)
    f = gemm_bf16_ref(c, w2)[0] + c2.float()
    return (h2 + g2.float() * f).reshape(B, N, D).to(dt)


def resmlp_block_plain(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """The JAX ``_plain_resmlp_block``: affines and LayerScale residuals in
    f32 rounded where it rounds, products and bias adds in the input dtype,
    the activation in f32 cast back."""
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    h = (x.float() * a1 + b1).to(dt)
    t = torch.matmul(wt, h) + bt[:, None]
    h = h.float() + g1 * t.float()
    h = (h * a2 + b2).to(dt)
    c = torch.matmul(h, w1.t()) + c1
    c = act(c.float()).to(dt)
    f = torch.matmul(c, w2.t()) + c2
    return (h.float() + g2 * f.float()).to(dt)


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def mode_launches():
    """{mode: n}: the wgmma core's launches so far by mode ("plain": FF2,
    "handoff": the token product and FF1); zeros if the library is not loaded."""
    if not _LIB.loaded:
        return dict.fromkeys(MODES, 0)
    return {k: _LIB.query("resmlp_mode_launches", v) for k, v in MODES.items()}


def routes():
    """{"sm90": n, "wmma": n}: the kernel's products so far on each bf16
    GEMM core (csrc/gemm_sm90.cuh), three a launch."""
    return _LIB.routes()


BLOCK_ARGS = ("x", "a1", "b1", "g1", "wt", "bt", "a2", "b2", "g2", "w1", "c1", "w2", "c2")


def _launch(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """The op's CUDA implementation: the kernel on the current stream."""
    global LAUNCHES
    weights = (a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2)
    B, N, D, F = block_dims(x, weights)
    require_bf16_contiguous((x, *weights))
    ws = torch.empty(_LIB.workspace(B, N, D, F), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    _LIB.launch("resmlp_block_bf16", x.device, (x, *weights, ws, out), (B, N, D, F))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def block_flops(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, *_, out_shape=None):
    """The block's products from the argument shapes (the op's flop
    formula): the token product 2·B·N·N·D and FF1, FF2 2·B·N·D·F each."""
    B, N, D = x
    return 2 * B * N * D * (N + 2 * w1[0])


OP = register("fused_resmlp_block", tensor_args(BLOCK_ARGS), _launch, resmlp_block_ref,
              block_flops)


def fused_resmlp_block(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """One ResMLP block, through the op ``jittor_mlp_tpu_torch::
    fused_resmlp_block``. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    weights = (a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2)
    check_block_input(x, "ResMLP-block")
    block_dims(x, weights)
    return OP(x, *weights)


def fused_resmlp_block_trainable(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """Differentiable ResMLP block: ``fused_resmlp_block`` forward (the
    kernel on the card), autograd of ``resmlp_block_plain`` backward."""
    return KernelForwardPlainBackward.apply(
        fused_resmlp_block, resmlp_block_plain, x, a1, b1, g1, wt, bt, a2, b2, g2,
        w1, c1, w2, c2)
