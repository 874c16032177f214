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
  arithmetic and chunk rule; its integer products are exact
  (``quant.exact_int_matmul``).
- ``fused_mixer_block_int8``: a CPU tensor goes to the twin; a CUDA bf16
  contiguous tensor launches the kernel; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ...core.nnf import gelu_tanh
from ...quant import exact_int_matmul, quant_act, quant_weight
from ._build import Library
from .mixer_block import block_dims, layer_norm_f32, require_bf16_contiguous

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("mixer_block_int8", ["mixer_block_int8.cu"],
               {"mixer_block_int8": (19, 5)}, error="mixer_int8_error_string",
               workspace={"mixer_block_int8_workspace": 5})


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
    qwt1, swt1 = quant_weight(wt1, 1)  # (TD, N), scales (TD, 1)
    qwt2, swt2 = quant_weight(wt2, 1)  # (N, TD), scales (N, 1)
    qwc1, swc1 = quant_weight(wc1, 1)  # (CD, D), scales (CD, 1)
    qwc2, swc2 = quant_weight(wc2, 1)  # (D, CD), scales (D, 1)
    # token mixes, per image; activation scales per column d
    qxn, sxn = quant_act(layer_norm_f32(x, ln1w, ln1b), 1)  # sxn (B, 1, D)
    t = exact_int_matmul(qwt1, qxn) * swt1 * sxn
    t = gelu_tanh(t + bt1.float()[:, None])
    qt, st = quant_act(t, 1)
    t2 = exact_int_matmul(qwt2, qt) * swt2 * st
    h = (x.float() + t2 + bt2.float()[:, None]).to(dt)
    # channel mixes over all rows, the hidden axis in chunks with
    # per-(row, chunk) activation scales
    qhn, shn = quant_act(layer_norm_f32(h, ln2w, ln2b).reshape(B * N, D), 1)
    ck = chunk_size(CD)
    acc = torch.zeros((B * N, D), dtype=torch.float32, device=x.device)
    for k0 in range(0, CD, ck):
        c = exact_int_matmul(qhn, qwc1[k0:k0 + ck].t()) * shn * swc1[k0:k0 + ck].t()
        c = gelu_tanh(c + bc1.float()[k0:k0 + ck])
        qc, sc = quant_act(c, 1)
        acc = acc + exact_int_matmul(qc, qwc2[:, k0:k0 + ck].t()) * sc * swc2.t()
    acc = acc + bc2.float()
    return (h.float().reshape(B * N, D) + acc).reshape(B, N, D).to(dt)


def _pad_cols(q, width):
    """int8 copy of q (rows, cols) with zero columns up to ``width``."""
    return F.pad(q, (0, width - q.shape[1])).to(torch.int8).contiguous()


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
        q = _pad_cols(q.reshape(-1, width), -(-width // 32) * 32).reshape(rows, -1)
        out += [q.contiguous(), s.reshape(-1).contiguous()]
    return out


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def fused_mixer_block_int8(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                           wc1, bc1, wc2, bc2):
    """One W8A8 Mixer block. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    global LAUNCHES
    weights = (ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2)
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    B, N, D, TD, CD = block_dims(x, weights)
    if x.device.type == "cpu":
        return mixer_block_int8_ref(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"no W8A8 mixer-block kernel for device {x.device}")
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
