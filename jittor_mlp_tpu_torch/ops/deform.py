"""The deformable ops on NHWC tensors (counterpart of
``jittor_mlp_tpu/ops/deform.py``): CycleMLP's and ActiveMLP's 1×1 ops and
the general modulated deformable convolution.

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

- ``deform_conv2d`` (DCNv1/v2, the op under ``ops/dcn.py``): each kernel
  tap of each output pixel samples the input at its grid position plus a
  learned (Δy, Δx), bilinearly from four corners, each zero outside the
  map, times an optional modulation mask; then one grouped product with
  the OIHW weight. The sampling positions and corner weights are float32
  for every input dtype (the JAX package builds the positions in x's
  dtype, so in bf16 a position at row 64 moves in steps of 0.25).

The products of these ops are plain ``torch.matmul`` / ``torch.einsum``:
the JAX package writes them as ``jnp.matmul`` / ``jnp.einsum``, outside
``nnf._dense``, so they stay out of int8 under ``int8_mode()``.
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


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def sample_positions(base, off):
    """A tap's sampling positions: the grid position ``base`` plus the
    offset ``off``, in float32 whatever the offset's dtype."""
    return base.float() + off.float()


def deform_conv2d(x, offset, weight, bias=None, stride=(1, 1), padding=(0, 0),
                  dilation=(1, 1), mask=None):
    """Modulated deformable convolution on NHWC x (B, H, W, Cin).

    offset: (B, Ho, Wo, 2·G·kh·kw), (Δy, Δx) interleaved per offset group g
    and tap k (channels 2(g·kh·kw + k) and 2(g·kh·kw + k) + 1); mask: (B, Ho,
    Wo, G·kh·kw) or None; weight: (Cout, Cin/wg, kh, kw), wg weight groups;
    bias: (Cout,) or None. Channel c of the input belongs to offset group
    c // (Cin/G). Returns (B, Ho, Wo, Cout) in x's dtype. Each tap is four
    row gathers of the (B, H·W, G, Cin/G) input and a float32 weighted sum,
    rounded once to x's dtype; the sampled columns (c·kh·kw + k, the OIHW
    order) go through one ``torch.einsum`` per weight group."""
    B, H, W, Cin = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    K = kh * kw
    G = offset.shape[-1] // (2 * K)
    off = offset.reshape(B, Ho, Wo, G, K, 2)
    msk = None if mask is None else mask.reshape(B, Ho, Wo, G, K).float()
    ys = (torch.arange(Ho, device=x.device) * sh - ph).reshape(1, Ho, 1, 1)
    xs = (torch.arange(Wo, device=x.device) * sw - pw).reshape(1, 1, Wo, 1)
    flat = x.reshape(B, H * W, G, Cin // G)
    bi = torch.arange(B, device=x.device).reshape(B, 1, 1)
    gi = torch.arange(G, device=x.device).reshape(1, 1, G)
    cols = []
    for k in range(K):
        i, j = divmod(k, kw)
        py = sample_positions(ys + i * dh, off[..., k, 0])  # (B, Ho, Wo, G)
        px = sample_positions(xs + j * dw, off[..., k, 1])
        y0, x0 = torch.floor(py), torch.floor(px)
        wy1, wx1 = py - y0, px - x0
        y0, x0 = y0.long(), x0.long()
        acc = 0.0
        for yy, wy in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
            for xx, wx in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
                valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(B, Ho * Wo, G)
                v = flat[bi, idx, gi].reshape(B, Ho, Wo, G, Cin // G)
                acc = acc + v.float() * torch.where(valid, wy * wx, 0.0)[..., None]
        if msk is not None:
            acc = acc * msk[..., k, None]
        cols.append(acc.to(x.dtype).reshape(B, Ho, Wo, Cin))
    wg = Cin // Cin_g
    col = torch.stack(cols, -1).reshape(B, Ho, Wo, wg, Cin_g * K)
    wmat = weight.to(x.dtype).reshape(wg, Cout // wg, Cin_g * K)
    out = torch.einsum("bhwgc,goc->bhwgo", col, wmat).reshape(B, Ho, Wo, Cout)
    return out if bias is None else out + bias.to(x.dtype)
