"""W8A8 ResMLP block forward: the hand-written CUDA kernel, its plain twin, the wrapper.

Replaces ``jittor_mlp_tpu/ops/pallas/resmlp_block_int8.py::
fused_resmlp_block_int8``. The kernel source is ``csrc/resmlp_block_int8.cu``
(its header says what bounds it on an H100 and what the design does about
that). Same signature and layouts as ``fused_resmlp_block``; every product
is int8 × int8 → int32, with the W8A8 Mixer block's recipe
(``mixer_block_int8``): weights quantized per output channel here, once per
call; activations per token column for the token mix and per (row, chunk)
for the FF, ck = F/4 when F % 4 == 0 and F ≥ 2048, else F. Unlike the bf16
block, nothing is rounded to x's dtype before the output:

    h1  = x·α1 + β1                                               f32
    h2  = (h1 + γ1·(deq(qWt·q(h1)) + bt))·α2 + β2                 f32
    out = dt(h2 + γ2·(Σ_chunks deq(q(gelu_tanh(deq(q(h2)·qW1ᵀ) + c1))·qW2ᵀ) + c2))

- ``resmlp_block_int8_ref``: plain PyTorch with the same quantization
  arithmetic and chunk rule, its three products the s8 core's twin
  ``ops.products.gemm_s8_ref`` on the kernel's operand layouts (codes
  zero-padded to 32, the token product's codes transposed and one an image
  with qWt shared, FF2 in chunks of ckp codes with a row scale a chunk
  where F ≥ 2048), as the kernel runs them on the s8 ``wgmma`` core; its
  integer products are exact.
- ``fused_resmlp_block_int8``: the op ``jittor_mlp_tpu_torch::
  fused_resmlp_block_int8`` (``_op.register``; ``OP``): a CPU tensor goes
  to the twin; a CUDA bf16 contiguous tensor launches the kernel; anything
  else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel;
  ``routes()``: its products on the s8 ``wgmma`` core (``sm90_s8``) and on
  the ``mma.sync`` core (``mma_s8``), three a launch.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_tanh
from ...quant import quant_act
from ..products import gemm_s8_ref
from ._build import S8_ROUTES, Library
from ._op import register, tensor_args
from .mixer_block import check_block_input, require_bf16_contiguous
from .mixer_block_int8 import pad_last, chunk_size, weight_operands
from .resmlp_block import BLOCK_ARGS, block_dims, block_flops

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("resmlp_block_int8", ["resmlp_block_int8.cu"],
               {"resmlp_block_int8": (18, 4)}, error="resmlp_int8_error_string",
               workspace={"resmlp_block_int8_workspace": 4},
               routes="resmlp_int8_gemm_products", route_names=S8_ROUTES)


def resmlp_block_int8_ref(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """Plain PyTorch twin of the kernel (and of the reference's
    ``_kernel_int8``), rounding where they round."""
    dt = x.dtype
    B, N, D = x.shape
    F = w1.shape[0]
    ck = chunk_size(F)
    nch = F // ck
    # the kernel's weight operands: (N, Np), (F, Dp), (D, nch·ckp)
    qwt, swt, qw1, sw1, qw2, sw2 = weight_operands((wt, w1, w2), ck)
    Np, Dp, ckp = qwt.shape[1], qw1.shape[1], qw2.shape[1] // nch
    h = x.float() * a1.float() + b1.float()
    # token mix, per image (qWt shared); activation scales per column d, the
    # codes transposed to (B, D, Np)
    qh, sh = quant_act(h, 1)  # sh (B, 1, D)
    t = gemm_s8_ref(qwt, pad_last(qh.transpose(1, 2), Np), swt, sh[:, 0]) + bt.float()[:, None]
    h = h + g1.float() * t
    hb = (h * a2.float() + b2.float()).reshape(B * N, D)
    # channel FF over all rows; the hidden axis in chunks with per-(row,
    # chunk) activation scales, each chunk's codes padded to ckp
    qhb, shb = quant_act(hb, 1)
    c = gelu_tanh(gemm_s8_ref(pad_last(qhb, Dp), qw1, shb[:, 0], sw1) + c1.float())
    qc, sc = quant_act(c.reshape(B * N, nch, ck), 2)
    qc = pad_last(qc, ckp).reshape(B * N, nch * ckp)
    if nch == 1:  # the kernel's unchunked product
        acc = gemm_s8_ref(qc, qw2, sc[:, 0, 0], sw2)
    else:
        acc = gemm_s8_ref(qc, qw2, sc[..., 0], sw2, chunk=ckp)
    return (hb + g2.float() * (acc + c2.float())).reshape(B, N, D).to(dt)


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90_s8": n, "mma_s8": n}: the kernel's products so far on each
    int8 GEMM core (csrc/gemm_sm90.cuh), three a launch."""
    return _LIB.routes()


def _launch(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """The op's CUDA implementation: the kernel on the current stream."""
    global LAUNCHES
    weights = (a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2)
    B, N, D, F = block_dims(x, weights)
    require_bf16_contiguous((x, *weights))
    qwt, swt, qw1, sw1, qw2, sw2 = weight_operands((wt, w1, w2), chunk_size(F))
    ws = torch.empty(_LIB.workspace(B, N, D, F), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    _LIB.launch("resmlp_block_int8", x.device,
                (x, a1, b1, g1, qwt, swt, bt, a2, b2, g2, qw1, sw1, c1, qw2, sw2, c2,
                 ws, out),
                (B, N, D, F))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


OP = register("fused_resmlp_block_int8", tensor_args(BLOCK_ARGS), _launch,
              resmlp_block_int8_ref, block_flops)


def fused_resmlp_block_int8(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """One W8A8 ResMLP block, through the op ``jittor_mlp_tpu_torch::
    fused_resmlp_block_int8``. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    weights = (a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2)
    check_block_input(x, "W8A8 ResMLP-block")
    block_dims(x, weights)
    return OP(x, *weights)
