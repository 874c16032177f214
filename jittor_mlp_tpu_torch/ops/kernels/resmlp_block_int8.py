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
  arithmetic and chunk rule; its integer products are exact.
- ``fused_resmlp_block_int8``: a CPU tensor goes to the twin; a CUDA bf16
  contiguous tensor launches the kernel; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_tanh
from ...quant import exact_int_matmul, quant_act, quant_weight
from ._build import Library
from .mixer_block import require_bf16_contiguous
from .mixer_block_int8 import chunk_size, weight_operands
from .resmlp_block import block_dims

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("resmlp_block_int8", ["resmlp_block_int8.cu"],
               {"resmlp_block_int8": (18, 4)}, error="resmlp_int8_error_string",
               workspace={"resmlp_block_int8_workspace": 4})


def resmlp_block_int8_ref(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """Plain PyTorch twin of the kernel (and of the reference's
    ``_kernel_int8``), rounding where they round."""
    dt = x.dtype
    B, N, D = x.shape
    F = w1.shape[0]
    qwt, swt = quant_weight(wt, 1)  # (N, N), scales (N, 1)
    qw1, sw1 = quant_weight(w1, 1)  # (F, D), scales (F, 1)
    qw2, sw2 = quant_weight(w2, 1)  # (D, F), scales (D, 1)
    h = x.float() * a1.float() + b1.float()
    # token mix, per image; activation scales per column d
    qh, sh = quant_act(h, 1)
    t = exact_int_matmul(qwt, qh) * swt * sh + bt.float()[:, None]
    h = h + g1.float() * t
    hb = (h * a2.float() + b2.float()).reshape(B * N, D)
    qhb, shb = quant_act(hb, 1)
    ck = chunk_size(F)
    acc = torch.zeros((B * N, D), dtype=torch.float32, device=x.device)
    for k0 in range(0, F, ck):
        c = exact_int_matmul(qhb, qw1[k0:k0 + ck].t()) * shb * sw1[k0:k0 + ck].t()
        c = gelu_tanh(c + c1.float()[k0:k0 + ck])
        qc, sc = quant_act(c, 1)
        acc = acc + exact_int_matmul(qc, qw2[:, k0:k0 + ck].t()) * sc * sw2.t()
    acc = acc + c2.float()
    return (hb + g2.float() * acc).reshape(B, N, D).to(dt)


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def fused_resmlp_block_int8(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """One W8A8 ResMLP block. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    global LAUNCHES
    weights = (a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2)
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    B, N, D, F = block_dims(x, weights)
    if x.device.type == "cpu":
        return resmlp_block_int8_ref(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"no W8A8 ResMLP-block kernel for device {x.device}")
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
