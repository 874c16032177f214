"""Plain products of the GEMM cores' modes (``csrc/gemm_sm90.cuh``).

The twins of the block kernels that run their products on the core, and the
core's checking entry (``ops/kernels/gemm_sm90.py``), share these:

- ``gemm_bf16_ref(a, b, a_mn=, b_mn=, slab=)``: a (M, K) or with ``a_mn``
  (K, M), b (N, K) or with ``b_mn`` (K, N); the f32 partial products over K
  in row slabs of ``slab`` rows (all of K by default), (partials, M, N).
- ``sum_slabs_ref(partials)``: the partials added in slab order, as the
  channel weight backward's ``sum_groups`` adds them.
- ``gemm_s8_ref(a, b, rs, cs)``: ``(f32(a · bᵀ) · rs) · cs``, the W8A8
  dequantization: the integer product exact and rounded once to f32, then
  the row scale, then the column scale.
"""

from __future__ import annotations

import torch

from ..quant import exact_int_matmul


def slab_rows(K, slab):
    """(partials, rows of each but the last) of a sum over K in slabs."""
    if slab is None:
        return 1, K
    if not isinstance(slab, int) or slab <= 0:
        raise ValueError(f"slab must be a positive int, got {slab!r}")
    return -(-K // slab), slab


def bf16_dims(a, b, a_mn, b_mn, slab):
    """(M, N, K) of the product of op(a) and op(b); raises on operands that
    do not agree, or slabs of K with a K-major operand."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"want 2-D operands, got {tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"operands on {b.device} and {a.device}")
    if b.dtype != a.dtype:
        raise TypeError(f"operands of dtypes {b.dtype} and {a.dtype}")
    if not a.is_floating_point():
        raise TypeError(f"the operands must be floating point, got {a.dtype}")
    K, M = a.shape if a_mn else a.shape[::-1]
    Kb, N = b.shape if b_mn else b.shape[::-1]
    if Kb != K:
        raise ValueError(f"a {tuple(a.shape)} (a_mn={a_mn}) and b {tuple(b.shape)} "
                         f"(b_mn={b_mn}) do not share K")
    nz, _ = slab_rows(K, slab)
    if nz > 1 and not (a_mn and b_mn):
        raise ValueError("slabs of K need both operands MN-major (a slab is a block of rows)")
    return M, N, K


def gemm_bf16_ref(a, b, *, a_mn=False, b_mn=False, slab=None):
    """(partials, M, N) f32, partial z the f32 product of op(a) and op(b)
    over K rows z·slab .. z·slab+slab−1 (the last partial may take fewer)."""
    M, N, K = bf16_dims(a, b, a_mn, b_mn, slab)
    A = a.float().t() if a_mn else a.float()  # (M, K)
    Bt = b.float() if b_mn else b.float().t()  # (K, N)
    _, step = slab_rows(K, slab)
    return torch.stack([torch.matmul(A[:, k:k + step], Bt[k:k + step])
                        for k in range(0, K, step)])


def sum_slabs_ref(partials):
    """The partials added in slab order."""
    out = partials[0].clone()
    for p in partials[1:]:
        out = out + p
    return out


def gemm_s8_ref(a, b, rs, cs):
    """``(f32(a · bᵀ) · rs) · cs``: the integer product exact and rounded
    once to f32, then the row scale, then the column scale, each rounded in
    f32 (a, b: int8 or floats holding ints; a leading batch dimension
    broadcasts)."""
    acc = exact_int_matmul(a.float(), b.float().transpose(-1, -2))
    return acc * rs.float()[..., :, None] * cs.float()[..., None, :]
