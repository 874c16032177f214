"""AS-MLP's axial shift: the hand-written CUDA kernel, its plain twin, the wrappers.

Replaces ``jittor_mlp_tpu/ops/pallas/shift_kernel.py::_call`` and its custom
VJP ``axial_shift_pallas``. The kernel source is ``csrc/axial_shift.cu``
(its header says what bounds it on an H100 and what the design does about
that). For x (B, H, W, C) and an axis (1 = H, 2 = W), channel group g of
``ceil(C/shift)`` channels reads from p + s along the axis, s = sign·-(g -
shift//2), and is zero outside; sign -1 is the gradient.

- ``axial_shift_ref``: the plain twin, ``ops.shift.axial_shift``.
- ``shift``: one call at a given sign, through the op
  ``jittor_mlp_tpu_torch::axial_shift`` (``_op.register``; ``OP``). A CPU
  tensor goes to the twin; a contiguous CUDA bf16 or float32 tensor
  launches the kernel; anything else raises. It never falls back to the
  twin on the card.
- ``axial_shift``: the differentiable shift (an ``autograd.Function``): the
  forward is ``shift`` at sign +1, the backward ``shift`` at sign -1 on the
  incoming gradient, as the JAX custom VJP's ``_bwd``.
- ``LAUNCHES``: how many times ``shift`` launched the kernel (forward and
  backward alike).
"""

from __future__ import annotations

import threading

import torch

from ..shift import axial_shift as axial_shift_ref
from ._build import Library
from ._op import register

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("axial_shift", ["axial_shift.cu"], {"axial_shift": (2, 8)},
               error="shift_error_string")


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def _launch(x, shift_size, axis, sign):
    """The op's CUDA implementation: the kernel on the current stream."""
    global LAUNCHES
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the axial-shift kernel takes bf16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the axial-shift kernel takes contiguous tensors only")
    out = torch.empty_like(x)
    if x.numel():
        _LIB.launch("axial_shift", x.device, (x, out),
                    (*x.shape, shift_size, axis, sign, x.element_size()))
        with _COUNT_LOCK:
            LAUNCHES += 1
    return out


OP = register("axial_shift", ["Tensor x", "int shift_size", "int axis", "int sign"], _launch,
              axial_shift_ref)


def shift(x, shift_size, axis, sign=1):
    """The shift of x (B, H, W, C) at ``sign`` (+1 forward, -1 gradient),
    through the op ``jittor_mlp_tpu_torch::axial_shift``. CPU: the plain
    twin. CUDA: the kernel on the current stream (bf16 or float32,
    contiguous); it raises on anything it does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    if axis not in (1, 2) or sign not in (1, -1) or shift_size < 1:
        raise ValueError(f"axis {axis}, sign {sign}, shift_size {shift_size}: want axis 1 or "
                         f"2, sign +1 or -1, shift_size >= 1")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no axial-shift kernel for device {x.device}")
    return OP(x, shift_size, axis, sign)


class AxialShift(torch.autograd.Function):
    """``shift`` at sign +1 forward, at sign -1 on the gradient backward."""

    @staticmethod
    def forward(ctx, x, shift_size, axis):
        ctx.args = (shift_size, axis)
        return shift(x, shift_size, axis, 1)

    @staticmethod
    def backward(ctx, g):
        shift_size, axis = ctx.args
        return shift(g.contiguous(), shift_size, axis, -1), None, None


def axial_shift(x, shift_size, axis):
    """AS-MLP's shift of x (B, H, W, C) along ``axis``, differentiable."""
    return AxialShift.apply(x, shift_size, axis)
