"""W8A8 Mixer block forward: the hand-written CUDA kernel, its plain twin, the wrapper.

Replaces ``jittor_mlp_tpu/ops/pallas/mixer_block_int8.py::
fused_mixer_block_int8``. The kernel source is ``csrc/mixer_block_int8.cu``
(its header says what bounds it on an H100 and what the design does about
that). Same signature and torch weight layouts as ``fused_mixer_block``;
every product is int8 × int8 → int32:

- weights: quantized per output channel here, in PyTorch, once per call
  (as the JAX wrapper quantizes them outside its kernel): absmax/127,
  round half to even;
- activations: quantized dynamically, per token column for the two token
  mixes, per (row, chunk of ck columns) for the two channel mixes, with
  ck = CD/4 when CD % 4 == 0 and CD ≥ 2048, else CD;
- LayerNorms, GELU (tanh form), biases, residuals and the dequantization
  in f32; h is rounded to x's dtype after the token mix, as in the
  reference.

- ``mixer_block_int8_ref``: plain PyTorch with the same quantization
  arithmetic and chunk rule, its four products the s8 core's twin
  ``ops.products.gemm_s8_ref`` on the kernel's operand layouts (codes
  zero-padded to 32, the token products' codes transposed and one an
  image, the second channel product in chunks of ckp codes with a row
  scale a chunk), as the kernel runs them on the s8 ``wgmma`` core; its
  integer products are exact.
- ``fused_mixer_block_int8``: the op ``jittor_mlp_tpu_torch::
  fused_mixer_block_int8`` (``_op.register``; ``OP``): a CPU tensor goes to
  the twin; a CUDA bf16 contiguous tensor launches the kernel; anything else
  raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel;
  ``routes()``: its products on the s8 ``wgmma`` core (``sm90_s8``) and on
  the ``mma.sync`` core (``mma_s8``), four a launch.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ...core.nnf import gelu_tanh
from ...quant import quant_act, quant_weight
from ..products import gemm_s8_ref
from ._build import S8_ROUTES, Library
from ._op import register, tensor_args
from .mixer_block import (BLOCK_ARGS, block_dims, block_flops, check_block_input, layer_norm_f32,
                          require_bf16_contiguous)

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("mixer_block_int8", ["mixer_block_int8.cu"],
               {"mixer_block_int8": (19, 5)}, error="mixer_int8_error_string",
               workspace={"mixer_block_int8_workspace": 5},
               routes="mixer_int8_gemm_products", route_names=S8_ROUTES)


def chunk_size(cd):
    """The channel mix's hidden chunk (``ck`` of the reference)."""
    return cd // 4 if cd % 4 == 0 and cd >= 2048 else cd


def mixer_block_int8_ref(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                         wc1, bc1, wc2, bc2):
    """Plain PyTorch twin of the kernel (and of the reference's
    ``_kernel_int8``), rounding where they round."""
    dt = x.dtype
    B, N, D = x.shape
    CD = wc1.shape[0]
    ck = chunk_size(CD)
    nch = CD // ck
    # the kernel's weight operands: (TD, Np), (N, TDp), (CD, Dp), (D, nch·ckp)
    qwt1, swt1, qwt2, swt2, qwc1, swc1, qwc2, swc2 = weight_operands((wt1, wt2, wc1, wc2), ck)
    Np, TDp, Dp, ckp = qwt1.shape[1], qwt2.shape[1], qwc1.shape[1], qwc2.shape[1] // nch
    # token mixes, per image (the weight shared); activation scales per
    # column d, the codes transposed to (B, D, Np) and (B, D, TDp)
    qxn, sxn = quant_act(layer_norm_f32(x, ln1w, ln1b), 1)  # sxn (B, 1, D)
    t = gemm_s8_ref(qwt1, pad_last(qxn.transpose(1, 2), Np), swt1, sxn[:, 0])
    t = gelu_tanh(t + bt1.float()[:, None])
    qt, st = quant_act(t, 1)
    t2 = gemm_s8_ref(qwt2, pad_last(qt.transpose(1, 2), TDp), swt2, st[:, 0])
    h = (x.float() + t2 + bt2.float()[:, None]).to(dt)
    # channel mixes over all rows; the hidden axis in chunks with
    # per-(row, chunk) activation scales, each chunk's codes padded to ckp
    qhn, shn = quant_act(layer_norm_f32(h, ln2w, ln2b).reshape(B * N, D), 1)
    c = gelu_tanh(gemm_s8_ref(pad_last(qhn, Dp), qwc1, shn[:, 0], swc1) + bc1.float())
    qc, sc = quant_act(c.reshape(B * N, nch, ck), 2)
    acc = gemm_s8_ref(pad_last(qc, ckp).reshape(B * N, nch * ckp), qwc2, sc[..., 0], swc2,
                      chunk=ckp)
    return (h.float().reshape(B * N, D) + (acc + bc2.float())).reshape(B, N, D).to(dt)


def pad_last(q, width):
    """q with zero codes appended along its last axis up to ``width``."""
    return F.pad(q, (0, width - q.shape[-1]))


def weight_operands(weights, ck):
    """The W8A8 kernels' weight operands, in order: each weight quantized per
    output channel (row) to int8, each row zero-padded to a multiple of 32
    codes, with its flat f32 scales. The last weight (the second channel
    product's, (D, CD)) is padded per chunk of ck columns instead."""
    out = []
    for i, w in enumerate(weights):
        q, s = quant_weight(w, 1)
        rows, cols = q.shape
        width = ck if i == len(weights) - 1 else cols
        q = pad_last(q.reshape(-1, width), -(-width // 32) * 32).reshape(rows, -1)
        out += [q.to(torch.int8).contiguous(), s.reshape(-1).contiguous()]
    return out


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90_s8": n, "mma_s8": n}: the kernel's products so far on each
    int8 GEMM core (csrc/gemm_sm90.cuh), four a launch."""
    return _LIB.routes()


def _launch(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2):
    """The op's CUDA implementation: the kernel on the current stream."""
    global LAUNCHES
    weights = (ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2)
    B, N, D, TD, CD = block_dims(x, weights)
    require_bf16_contiguous((x, *weights))
    qwt1, swt1, qwt2, swt2, qwc1, swc1, qwc2, swc2 = weight_operands(
        (wt1, wt2, wc1, wc2), chunk_size(CD))
    ws = torch.empty(_LIB.workspace(B, N, D, TD, CD), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    _LIB.launch("mixer_block_int8", x.device,
                (x, ln1w, ln1b, qwt1, swt1, bt1, qwt2, swt2, bt2, ln2w, ln2b,
                 qwc1, swc1, bc1, qwc2, swc2, bc2, ws, out),
                (B, N, D, TD, CD))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


OP = register("fused_mixer_block_int8", tensor_args(BLOCK_ARGS), _launch, mixer_block_int8_ref,
              block_flops)


def fused_mixer_block_int8(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                           wc1, bc1, wc2, bc2):
    """One W8A8 Mixer block, through the op ``jittor_mlp_tpu_torch::
    fused_mixer_block_int8``. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    weights = (ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2)
    check_block_input(x, "W8A8 mixer-block")
    block_dims(x, weights)
    return OP(x, *weights)
