"""W8A8 gMLP block forward: the hand-written CUDA kernel, its plain twin, the wrapper.

Replaces ``jittor_mlp_tpu/ops/pallas/gmlp_block_int8.py::
fused_gmlp_block_int8``. The kernel source is ``csrc/gmlp_block_int8.cu``
(its header says what bounds it on an H100 and what the design does about
that). Same signature and layouts as ``fused_gmlp_block``; every product is
int8 × int8 → int32, with the W8A8 recipe of ``mixer_block_int8``: weights
quantized per output channel here, once per call; activations per row for
the two channel products (over the whole D and the whole F: no chunks)
and per image, per column over the tokens for the spatial product.
Nothing is rounded to x's dtype before the output:

    xn  = LN1(x)                                                  f32
    y   = gelu_tanh(deq(q(xn)·qW1ᵀ) + b1);  u, v = y[:, :F], y[:, F:]
    v2  = deq(qWsp·q(LN2(v))) + bs                                per image
    out = dt(x + (deq(q(u·v2)·qW2ᵀ) + b2))

- ``gmlp_block_int8_ref``: plain PyTorch with the same quantization
  arithmetic and multiplication order, its three products the s8 core's
  twin ``ops.products.gemm_s8_ref`` (exact integer products, then the row and
  the column scale), as the kernel runs them on the s8 ``wgmma`` core.
- ``fused_gmlp_block_int8``: a CPU tensor goes to the twin; a CUDA bf16
  contiguous tensor launches the kernel; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel;
  ``routes()``: its products on the s8 ``wgmma`` core (``sm90_s8``) and on
  the ``mma.sync`` core (``mma_s8``), three a launch.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_tanh
from ...quant import quant_act, quant_weight
from ..products import gemm_s8_ref
from ._build import S8_ROUTES, Library
from .gmlp_block import block_dims
from .mixer_block import layer_norm_f32, require_bf16_contiguous
from .mixer_block_int8 import weight_operands

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("gmlp_block_int8", ["gmlp_block_int8.cu"], {"gmlp_block_int8": (16, 4)},
               error="gmlp_int8_error_string", workspace={"gmlp_block_int8_workspace": 4},
               routes="gmlp_int8_gemm_products", route_names=S8_ROUTES)


def gmlp_block_int8_ref(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """Plain PyTorch twin of the kernel (and of the reference's
    ``_kernel_int8``), rounding where they round."""
    dt = x.dtype
    B, N, D = x.shape
    F = w1.shape[0] // 2
    qw1, sw1 = quant_weight(w1, 1)  # (2F, D), scales (2F, 1)
    qwsp, swsp = quant_weight(wsp, 1)  # (N, N), scales (N, 1)
    qw2, sw2 = quant_weight(w2, 1)  # (D, F), scales (D, 1)
    qxn, sxn = quant_act(layer_norm_f32(x, ln1w, ln1b).reshape(B * N, D), 1)
    y = gelu_tanh(gemm_s8_ref(qxn, qw1, sxn[:, 0], sw1[:, 0]) + b1.float())
    u, v = y[:, :F], y[:, F:]
    # spatial product, per image (qWsp shared); activation scales per column f
    qv, sv = quant_act(layer_norm_f32(v, sgu_w, sgu_b).reshape(B, N, F), 1)
    v2 = gemm_s8_ref(qwsp, qv.transpose(1, 2), swsp[:, 0], sv[:, 0]) + bs.float()[:, None]
    g = u * v2.reshape(B * N, F)
    qg, sg = quant_act(g, 1)
    h = gemm_s8_ref(qg, qw2, sg[:, 0], sw2[:, 0]) + b2.float()
    return (x.float().reshape(B * N, D) + h).reshape(B, N, D).to(dt)


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90_s8": n, "mma_s8": n}: the kernel's products so far on each
    int8 GEMM core (csrc/gemm_sm90.cuh), three a launch."""
    return _LIB.routes()


def fused_gmlp_block_int8(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """One W8A8 gMLP block. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    global LAUNCHES
    weights = (ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2)
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    B, N, D, F = block_dims(x, weights)
    if x.device.type == "cpu":
        return gmlp_block_int8_ref(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"no W8A8 gMLP-block kernel for device {x.device}")
    require_bf16_contiguous((x, *weights))
    # the last weight's chunk is the whole F: one activation scale per row
    qw1, sw1, qwsp, swsp, qw2, sw2 = weight_operands((w1, wsp, w2), F)
    ws = torch.empty(_LIB.workspace(B, N, D, F), dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    _LIB.launch("gmlp_block_int8", x.device,
                (x, ln1w, ln1b, qw1, sw1, b1, sgu_w, sgu_b, qwsp, swsp, bs, qw2, sw2, b2,
                 ws, out),
                (B, N, D, F))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
