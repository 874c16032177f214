"""One Mixer channel product on the Hopper GEMM core: the checking entry, its plain twin.

Kernel 1 (``mixer_block``) and the training forward (``mixer_block_bwd.fwd_with_h``)
run both channel products of the block on ``csrc/gemm_sm90.cuh``: TMA loads
into a 128-byte-swizzled shared-memory ring, ``wgmma`` from warp-specialized
warpgroups (its header says what bounds it on an H100 and what the design
does about that). The core replaces the channel half of
``jittor_mlp_tpu/ops/pallas/mixer_block.py::fused_mixer_block``. This module
launches one such product on its own (``csrc/gemm_sm90.cu``), so that
``chip_smoke.py`` can hold the core against its plain version and time it
against the WMMA core and the library. Nothing on the serving or training
path calls it: it is an instrument, like ``tools/kernel_lab.py``.

For a (M, K), b (N, K) (a torch Linear weight) and bias (N,):

    act="gelu_tanh":  out = bf16(gelu_tanh(a · bᵀ + bias))
    residual=R:       out = bf16(R + (a · bᵀ + bias)),  R (M, N)

with f32 sums, the rounding points of ``GeluBias`` and ``ResidualBias``
(``csrc/gemm_bf16.cuh``), which kernel 1 uses for these products.

- ``gemm_tn_ref``: plain PyTorch, the f32 product of the operands, then the
  epilogue's arithmetic and one rounding to the operands' dtype. It also
  takes ``act="gelu_erf"`` (the float32 block's activation), which the
  kernel does not.
- ``gemm_tn``: a CPU tensor goes to ``gemm_tn_ref``; a contiguous bf16 CUDA
  tensor launches the kernel on the current stream, on ``core`` ``"auto"``
  (the wgmma core where TMA can load both operands, else the WMMA core),
  ``"sm90"`` (the wgmma core, or raise) or ``"wmma"``; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel;
  ``routes()``: its products on each core; ``config()``: the core's tile,
  ring stages and shared memory.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ._build import Library
from .mixer_block import require_bf16_contiguous

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("gemm_sm90", ["gemm_sm90.cu"], {"gemm_tn_bf16": (5, 5)},
               error="gemm_error_string", queries={"gemm_sm90_config": 1},
               routes="gemm_tn_products")
CORES = {"auto": 0, "sm90": 1, "wmma": 2}
_ACTS = {"gelu_tanh": gelu_tanh, "gelu_erf": gelu_erf}


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90": n, "wmma": n}: the products this entry launched on each core."""
    return _LIB.routes()


def config():
    """The wgmma core's block tile, K step, ring stages and dynamic shared
    memory in bytes, as compiled."""
    keys = ("tile_m", "tile_n", "tile_k", "stages", "smem_bytes")
    return {k: _LIB.query("gemm_sm90_config", i) for i, k in enumerate(keys)}


def _args(a, b, bias, act, residual):
    if a.dim() != 2 or b.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"want a (M, K), b (N, K), bias (N,); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(bias.shape)}")
    (M, K), (N, Kb) = a.shape, b.shape
    if Kb != K or bias.shape[0] != N:
        raise ValueError(f"a (M, K) {tuple(a.shape)}, b (N, K) {tuple(b.shape)} and bias "
                         f"{tuple(bias.shape)} do not agree")
    if (act is None) == (residual is None):
        raise ValueError("give exactly one of act= and residual=")
    if act is not None and act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"residual must be (M, N) = {(M, N)}, got {tuple(residual.shape)}")
    tensors = (a, b, bias) + (() if residual is None else (residual,))
    for t in tensors:
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"operands of dtypes {t.dtype} and {a.dtype}")
    if not a.is_floating_point():
        raise TypeError(f"the operands must be floating point, got {a.dtype}")
    return M, N, K


def gemm_tn_ref(a, b, bias, *, act=None, residual=None):
    """The plain twin: f32 sums of the operands, then ``act(acc + bias)`` or
    ``residual + (acc + bias)`` in f32, rounded once to the operands' dtype."""
    _args(a, b, bias, act, residual)
    acc = torch.matmul(a.float(), b.float().t())
    if residual is None:
        out = _ACTS[act](acc + bias.float())
    else:
        out = residual.float() + (acc + bias.float())
    return out.to(a.dtype)


def gemm_tn(a, b, bias, *, act=None, residual=None, core="auto"):
    """One channel product. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous, ``act`` "gelu_tanh" or a residual) on ``core``, launched on
    the current stream; it raises on anything it does not take and never
    falls back to the twin."""
    global LAUNCHES
    M, N, K = _args(a, b, bias, act, residual)
    if core not in CORES:
        raise ValueError(f"core must be one of {sorted(CORES)}, got {core!r}")
    if a.device.type == "cpu":
        return gemm_tn_ref(a, b, bias, act=act, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    if act not in (None, "gelu_tanh"):
        raise ValueError(f"the kernel's activation is gelu_tanh, got {act!r}")
    require_bf16_contiguous((a, b, bias) + (() if residual is None else (residual,)))
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    r = out if residual is None else residual  # read only with a residual
    _LIB.launch("gemm_tn_bf16", a.device, (a, b, bias, r, out),
                (M, N, K, 0 if residual is None else 1, CORES[core]))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
