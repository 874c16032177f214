"""gMLP block forward: the hand-written CUDA kernel, its plain twin, the wrapper.

Replaces ``jittor_mlp_tpu/ops/pallas/gmlp_block.py::fused_gmlp_block``. The
kernel source is ``csrc/gmlp_block.cu`` (its header says what bounds it on
an H100 and what the design does about that). For x (B, N, D):

    xn  = dt(LN1(x))                              f32 stats and affine
    y   = dt(act(xn·W1ᵀ + b1));  u, v = y[:, :F], y[:, F:]
    vn  = dt(LN2(v))                              the spatial gating unit's norm
    v2  = dt(Wsp·vn + bs)                         per image
    g   = dt(u·v2)                                in f32, rounded
    out = dt(x + (g·W2ᵀ + b2))

with dt the input dtype, act the tanh-form GELU for bf16 (the kernel
evaluates it as x·σ(2u) on the special-function unit, within the bound
``csrc/common.cuh`` states; the twins keep ``torch.tanh``) and the exact
one for float32, and the weights in their torch layouts: w1 (2F, D)
[channel_proj1], wsp (N, N) [sgu.spatial_proj, the Conv1d squeezed],
w2 (D, F) [channel_proj2].

- ``gmlp_block_ref``: plain PyTorch with the kernel's rounding points, its
  three products the core's twin ``ops.products.gemm_bf16_ref`` on the
  kernel's layouts (xn and g K-major over all B·N rows; Wsp in rows of
  Np = round_up(N, 8) read as its first N columns, shared by every image,
  and vn an N-major B operand an entry an image).
- ``fused_gmlp_block``: the op ``jittor_mlp_tpu_torch::fused_gmlp_block``
  (``_op.register``; ``OP``): a CPU tensor goes to the twin; a CUDA bf16
  contiguous tensor launches the kernel; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel;
  ``mode_launches()``: the ``wgmma`` core's launches by mode (two on the
  handoff schedule a launch, GEMM1 and the token product; one plain, GEMM2);
  ``routes()``: its products on the bf16 ``wgmma`` core (``sm90``) and on
  the WMMA core (``wmma``), three a launch: the ``wgmma`` core where TMA
  can load the operands (D and F multiples of 8), else WMMA.
- ``gmlp_block_plain``: the JAX ``_plain_gmlp_block`` (products and bias adds
  in the input dtype), whose autograd is the training backward.
- ``fused_gmlp_block_trainable``: forward ``fused_gmlp_block``, backward
  autograd of ``gmlp_block_plain``.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ..products import gemm_bf16_ref
from ._build import Library
from ._op import register, tensor_args
from .mixer_block import (KernelForwardPlainBackward, check_block_input, check_weights,
                          layer_norm_f32, require_bf16_contiguous)

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("gmlp_block", ["gmlp_block.cu"], {"gmlp_block_bf16": (13, 4)},
               error="gmlp_error_string", workspace={"gmlp_block_bf16_workspace": 4},
               queries={"gmlp_mode_launches": 1}, routes="gmlp_gemm_products")
# the wgmma core's launch modes this library runs: GEMM1 and the token product on the
# handoff schedule, GEMM2 on the plain mode
MODES = {"plain": 0, "handoff": 4}


def block_dims(x, weights):
    """Check the block's 10 weights against x (B, N, D) in shape and device;
    return (B, N, D, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got shape {tuple(x.shape)}")
    B, N, D = x.shape
    F = weights[2].shape[0] // 2
    want = [(D,), (D,), (2 * F, D), (2 * F,), (F,), (F,), (N, N), (N,), (D, F), (D,)]
    names = ["ln1w", "ln1b", "w1", "b1", "sgu_w", "sgu_b", "wsp", "bs", "w2", "b2"]
    check_weights(x, weights, names, want)
    return B, N, D, F


def gmlp_block_ref(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """Plain PyTorch twin of the kernel, rounding where the kernel rounds.
    On CUDA the float32 matmuls need TF32 off (PyTorch's default for
    matmuls) to match."""
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    B, N, D = x.shape
    F = w1.shape[0] // 2
    xn = layer_norm_f32(x, ln1w, ln1b).to(dt).reshape(B * N, D)
    y = act(gemm_bf16_ref(xn, w1)[0] + b1.float()).to(dt)  # (B·N, 2F)
    u, v = y[:, :F], y[:, F:]
    vn = layer_norm_f32(v, sgu_w, sgu_b).to(dt).reshape(B, N, F)
    wsp_rows = torch.nn.functional.pad(wsp, (0, -N % 8))  # the kernel's copy: rows of Np
    v2 = (gemm_bf16_ref(wsp_rows[:, :N], vn, b_mn=True) + bs.float()[:, None]).to(dt)
    g = (u.float() * v2.reshape(B * N, F).float()).to(dt)
    out = x.float().reshape(B * N, D) + (gemm_bf16_ref(g, w2)[0] + b2.float())
    return out.reshape(B, N, D).to(dt)


def gmlp_block_plain(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """The JAX ``_plain_gmlp_block``: f32 LayerNorms cast to the input
    dtype, products and bias adds in the input dtype, the activation and
    the gate in f32 cast back."""
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    F = w1.shape[0] // 2
    y = torch.matmul(layer_norm_f32(x, ln1w, ln1b).to(dt), w1.t()) + b1
    y = act(y.float()).to(dt)
    u, v = y[..., :F], y[..., F:]
    vn = layer_norm_f32(v, sgu_w, sgu_b).to(dt)
    v2 = torch.matmul(wsp, vn) + bs[:, None]
    g = (u.float() * v2.float()).to(dt)
    return x + torch.matmul(g, w2.t()) + b2


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def mode_launches():
    """{mode: n}: the wgmma core's launches so far by mode ("plain": GEMM2,
    "handoff": GEMM1 and the token product); zeros if the library is not loaded."""
    if not _LIB.loaded:
        return dict.fromkeys(MODES, 0)
    return {k: _LIB.query("gmlp_mode_launches", v) for k, v in MODES.items()}


def routes():
    """{"sm90": n, "wmma": n}: the kernel's products so far on each bf16
    GEMM core (csrc/gemm_sm90.cuh), three a launch."""
    return _LIB.routes()


BLOCK_ARGS = ("x", "ln1w", "ln1b", "w1", "b1", "sgu_w", "sgu_b", "wsp", "bs", "w2", "b2")


def _launch(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """The op's CUDA implementation: the kernel on the current stream."""
    global LAUNCHES
    weights = (ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2)
    B, N, D, F = block_dims(x, weights)
    require_bf16_contiguous((x, *weights))
    ws = torch.empty(_LIB.workspace(B, N, D, F), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    _LIB.launch("gmlp_block_bf16", x.device, (x, *weights, ws, out), (B, N, D, F))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def block_flops(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, *_, out_shape=None):
    """The block's products from the argument shapes (the op's flop
    formula): GEMM1 2·B·N·D·2F, the token product 2·B·N·N·F, GEMM2
    2·B·N·F·D."""
    B, N, D = x
    F = w1[0] // 2
    return 2 * B * N * F * (3 * D + N)


OP = register("fused_gmlp_block", tensor_args(BLOCK_ARGS), _launch, gmlp_block_ref, block_flops)


def fused_gmlp_block(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """One gMLP block, through the op ``jittor_mlp_tpu_torch::
    fused_gmlp_block``. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    weights = (ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2)
    check_block_input(x, "gMLP-block")
    block_dims(x, weights)
    return OP(x, *weights)


def fused_gmlp_block_trainable(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """Differentiable gMLP block: ``fused_gmlp_block`` forward (the kernel
    on the card), autograd of ``gmlp_block_plain`` backward."""
    return KernelForwardPlainBackward.apply(
        fused_gmlp_block, gmlp_block_plain, x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs,
        w2, b2)
