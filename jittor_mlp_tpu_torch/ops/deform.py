"""The deformable 1×1 ops of CycleMLP and ActiveMLP on NHWC tensors
(counterpart of ``jittor_mlp_tpu/ops/deform.py``'s model ops).

- ``cycle_fc`` (CycleMLP's CycleFC): channel i reads the input shifted by
  δᵢ = (i + start) % K − K//2 along the kernel's long axis, start =
  (kh·kw)//2, zero outside; then one product with the 1×1 weight. The
  shifted channels are gathered once (a slice copy per channel class); the
  JAX package's K masked weight matrices and K products are a TPU lowering
  and are not ported, so the sum order differs from JAX's.
- ``atm_sample`` and ``atm_op`` (ActiveMLP's ATMOp): a per-channel 1-D
  bilinear sample along H or W with learned offsets, zero outside, as a
  gather of the two neighbours and a lerp; one offset serves each group of
  ``share`` channels. Positions and fractions are taken in float32 from the
  offset alone, also for bf16 tensors. ``band`` clamps the offsets to
  ±band and then samples exactly. The JAX hat-matrix contraction and its
  banded sampler are TPU lowerings and are not ported.

The products of both ops are plain ``torch.matmul``: the JAX package
writes them as ``jnp.matmul``, outside ``nnf._dense``, so they stay out of
int8 under ``int8_mode()``.
"""

from __future__ import annotations

import numpy as np
import torch


def cycle_offset(c, kh, kw):
    """CycleFC's registered ``offset`` buffer (the reference's
    ``gen_offset``), shape (1, 2c, 1, 1), (Δy, Δx) interleaved per channel;
    a copy of the JAX ``models/cycle_mlp.py::_gen_offset``."""
    off = np.zeros((1, 2 * c, 1, 1), np.float32)
    start = (kh * kw) // 2
    for i in range(c):
        if kh == 1:
            off[0, 2 * i + 1] = (i + start) % kw - kw // 2
        else:
            off[0, 2 * i] = (i + start) % kh - kh // 2
    return off


def cycle_shift(x, kernel_size):
    """x (B, H, W, C) with channel i shifted by δᵢ = (i + start) % K − K//2
    along H (kh > 1) or W (kw > 1), zero outside: y[..., p, ..., i] =
    x[..., p + δᵢ, ..., i]."""
    kh, kw = kernel_size
    if kh != 1 and kw != 1:
        raise ValueError(f"CycleFC kernel {kernel_size}: one side must be 1")
    K = max(kh, kw)
    axis = 1 if kh > 1 else 2
    start = (kh * kw) // 2
    n = x.shape[axis]
    y = torch.zeros_like(x)
    for r in range(min(K, x.shape[-1])):  # channel class r: channels i ≡ r (mod K)
        d = (r + start) % K - K // 2
        if abs(d) >= n:
            continue
        src = x[..., r::K].narrow(axis, max(d, 0), n - abs(d))
        y[..., r::K].narrow(axis, max(-d, 0), n - abs(d)).copy_(src)
    return y


def cycle_fc(x, weight, bias, kernel_size):
    """CycleFC on NHWC x: ``cycle_shift`` then x @ weight[:, :, 0, 0]ᵀ
    (+ bias)."""
    y = torch.matmul(cycle_shift(x, kernel_size), weight[:, :, 0, 0].t().to(x.dtype))
    return y if bias is None else y + bias


def atm_sample(x, offset, axis, share=1, band=None):
    """Per-channel 1-D bilinear sample of x (B, H, W, C) along ``axis`` (1:
    H, 2: W), zero outside: out[..., p, ..., c] = (1 − f)·x[..., p + b, ...,
    c] + f·x[..., p + b + 1, ..., c], with b = ⌊o⌋ and f = o − b of the
    offset o of c's group. ``offset`` (B, H, W, C // share) holds one offset
    a group of ``share`` channels (what the reference's repeat_interleave
    spreads over them). b and f are taken in float32 from the offset, so a
    bf16 offset keeps its fraction at any position. ``band``: the offsets
    clamped to ±band first."""
    B, H, W, C = x.shape
    n = x.shape[axis]
    g = C // share
    off = offset.reshape(B, H, W, g, 1).float()
    if band is not None:
        off = off.clamp(-band, band)
    base = torch.floor(off)
    frac = off - base
    shape = [1] * 5
    shape[axis] = n
    pos0 = torch.arange(n, device=x.device).reshape(shape) + base.long()
    xg = x.reshape(B, H, W, g, share)

    def take(pos, weight):  # x at pos (zero outside), times its lerp weight
        valid = (pos >= 0) & (pos < n)
        v = torch.gather(xg, axis, pos.clamp(0, n - 1).expand(B, H, W, g, share))
        return v.float() * torch.where(valid, weight, 0.0)

    y = take(pos0, 1.0 - frac) + take(pos0 + 1, frac)
    return y.to(x.dtype).reshape(B, H, W, C)


def atm_op(x, offset, weight, bias, dimension, share=1, band=None):
    """ActiveMLP's ATMOp on NHWC x: ``atm_sample`` along ``dimension`` ("h"
    or "w"), then x @ weight[:, :, 0, 0]ᵀ (+ bias)."""
    y = atm_sample(x, offset, 1 if dimension == "h" else 2, share=share, band=band)
    y = torch.matmul(y, weight[:, :, 0, 0].t().to(x.dtype))
    return y if bias is None else y + bias
