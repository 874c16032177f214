"""Spatial shifts in plain PyTorch (counterpart of ``jittor_mlp_tpu/ops/shift.py``).

S2-MLP's four-way shifts (``spatial_shift1``, ``spatial_shift2``) have
functional-read edges: the interior moves by one along the axis and the
boundary row or column keeps its own value (``x[1:] = x[:-1]`` read from the
unshifted input, not torch's cascading in-place assignment). The channel
groups split at exactly c//4, c//2 and 3c//4, which differ from equal
quarters when c % 4 != 0.

AS-MLP's zero-fill axial shift: on NHWC input, channel group g (of ``ceil(C/shift)`` channels) reads from
position p + s along the axis, with s = -(g - shift//2), and is zero where
p + s falls outside: the semantics of the reference's CUDA shift. ``sign=-1``
negates every s, which is the shift's gradient. Each group is a narrow and a
concatenation with zeros, so autograd differentiates it.
"""

from __future__ import annotations

import math

import torch


def _shift_edge(x, axis, direction):
    """out[i] = x[i - direction] in range; the boundary keeps x's value.
    direction=+1 is ``x[1:] = x[:-1]`` read functionally, -1 its mirror."""
    n = x.shape[axis]
    if direction == 1:
        return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    return torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)


def _four_way(x, first, second):
    c = x.shape[-1]
    b1, b2, b3 = c // 4, c // 2, 3 * c // 4
    return torch.cat([
        _shift_edge(x[..., :b1], first, +1),
        _shift_edge(x[..., b1:b2], first, -1),
        _shift_edge(x[..., b2:b3], second, +1),
        _shift_edge(x[..., b3:], second, -1),
    ], -1)


def spatial_shift1(x):
    """S2-MLP's shift on NHWC x: the first two channel groups shift +1/-1
    along H, the last two along W."""
    return _four_way(x, 1, 2)


def spatial_shift2(x):
    """The opposite pattern (S2-MLP v2): W first, then H."""
    return _four_way(x, 2, 1)


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
