"""AS-MLP's zero-fill axial shift in plain PyTorch (counterpart of
``jittor_mlp_tpu/ops/shift.py::axial_shift``).

On NHWC input, channel group g (of ``ceil(C/shift)`` channels) reads from
position p + s along the axis, with s = -(g - shift//2), and is zero where
p + s falls outside: the semantics of the reference's CUDA shift. ``sign=-1``
negates every s, which is the shift's gradient. Each group is a narrow and a
concatenation with zeros, so autograd differentiates it.
"""

from __future__ import annotations

import math

import torch


def _shift_zero(x, axis, s):
    """out[i] = x[i+s] in range, else 0, along ``axis``."""
    n = x.shape[axis]
    if s == 0:
        return x
    zeros = x.new_zeros(x.shape[:axis] + (min(abs(s), n),) + x.shape[axis + 1:])
    if abs(s) >= n:
        return zeros
    if s > 0:
        return torch.cat([x.narrow(axis, s, n - s), zeros], axis)
    return torch.cat([zeros, x.narrow(axis, 0, n + s)], axis)


def axial_shift(x, shift_size, axis, sign=1):
    """The shift of x (B, H, W, C) along ``axis`` (1 = H, 2 = W); ``sign=-1``
    gives its gradient."""
    C = x.shape[-1]
    group = math.ceil(C / shift_size)
    parts = []
    for c0 in range(0, C, group):
        s = sign * -(c0 // group - shift_size // 2)
        parts.append(_shift_zero(x[..., c0:min(c0 + group, C)], axis, s))
    return torch.cat(parts, -1)
