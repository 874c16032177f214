"""Plain products of the GEMM cores' modes (``csrc/gemm_sm90.cuh``).

The twins of the block kernels that run their products on the core, and the
core's checking entry (``ops/kernels/gemm_sm90.py``), share these:

- ``gemm_bf16_ref(a, b, a_mn=, b_mn=, slab=)``: a (M, K) or with ``a_mn``
  (K, M), b (N, K) or with ``b_mn`` (K, N); the f32 partial products over K
  in row slabs of ``slab`` rows (all of K by default), (partials, M, N); or,
  where an operand has a leading batch dimension, one product an entry
  (the other operand shared), (entries, M, N).
- ``sum_slabs_ref(partials)``: the partials added in slab order, as the
  channel weight backward's ``sum_groups`` adds them.
- ``gemm_bf16_dual_ref(a1, b1, a2, b2, epi, a_mn=, b_mn=)``: the dual mode,
  two products of the same shape, ``epi(v1, v2)`` of their f32 results
  (each as ``gemm_bf16_ref``'s, (entries, M, N)); by default the pair.
- ``gemm_bf16_group_ref(a, b, per)``: the Group mode, a (images, M, K) and
  b (images, N, K) K-major; one f32 partial a group of ``per`` images (the
  last may hold fewer), its images' products added in order, (groups, M,
  N); ``sum_slabs_ref`` adds the partials.
- ``gemm_s8_ref(a, b, rs, cs, chunk=)``: ``(f32(a · bᵀ) · rs) · cs``, the
  W8A8 dequantization: the integer product exact and rounded once to f32,
  then the row scale, then the column scale; with ``chunk``, K in pieces of
  ``chunk`` codes, one row scale a (row, piece), the pieces' dequantized
  products added in piece order from zero (the core's chunked mode).
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
    """(entries, M, N, K) of the product of op(a) and op(b), entries 1 unless
    an operand has a leading batch dimension; raises on operands that do not
    agree, slabs of K with a K-major operand, or slabs of batched operands."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"want 2-D operands or 3-D batches, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"operands on {b.device} and {a.device}")
    if b.dtype != a.dtype:
        raise TypeError(f"operands of dtypes {b.dtype} and {a.dtype}")
    if not a.is_floating_point():
        raise TypeError(f"the operands must be floating point, got {a.dtype}")
    K, M = a.shape[-2:] if a_mn else a.shape[-2:][::-1]
    Kb, N = b.shape[-2:] if b_mn else b.shape[-2:][::-1]
    if Kb != K:
        raise ValueError(f"a {tuple(a.shape)} (a_mn={a_mn}) and b {tuple(b.shape)} "
                         f"(b_mn={b_mn}) do not share K")
    sizes = {t.shape[0] for t in (a, b) if t.dim() == 3}
    if len(sizes) > 1:
        raise ValueError(f"batches of {sorted(sizes)} entries do not agree")
    nz = sizes.pop() if sizes else 1
    parts, _ = slab_rows(K, slab)
    if parts > 1 and not (a_mn and b_mn):
        raise ValueError("slabs of K need both operands MN-major (a slab is a block of rows)")
    if parts > 1 and a.dim() + b.dim() > 4:
        raise ValueError("slabs of K and batch entries do not go together")
    return nz, M, N, K


def gemm_bf16_ref(a, b, *, a_mn=False, b_mn=False, slab=None):
    """(partials, M, N) f32, partial z the f32 product of op(a) and op(b)
    over K rows z·slab .. z·slab+slab−1 (the last partial may take fewer);
    or, where an operand is batched, (entries, M, N), entry z the f32
    product of op(a[z]) and op(b[z]) (a 2-D operand shared)."""
    nz, M, N, K = bf16_dims(a, b, a_mn, b_mn, slab)

    def entry(t, z):
        return t[z] if t.dim() == 3 else t

    if a.dim() == 3 or b.dim() == 3:
        return torch.stack([gemm_bf16_ref(entry(a, z), entry(b, z), a_mn=a_mn, b_mn=b_mn)[0]
                            for z in range(nz)])
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


def gemm_bf16_dual_ref(a1, b1, a2, b2, epi=None, *, a_mn=False, b_mn=False):
    """``epi(v1, v2)`` with v1 = gemm_bf16_ref(a1, b1) and v2 =
    gemm_bf16_ref(a2, b2), both (entries, M, N) f32 with the same (TA, TB)
    reading; by default the pair (v1, v2). The two products must have one
    shape."""
    v1 = gemm_bf16_ref(a1, b1, a_mn=a_mn, b_mn=b_mn)
    v2 = gemm_bf16_ref(a2, b2, a_mn=a_mn, b_mn=b_mn)
    if v1.shape != v2.shape:
        raise ValueError(f"the two products differ in shape: {tuple(v1.shape)} and "
                         f"{tuple(v2.shape)}")
    return (v1, v2) if epi is None else epi(v1, v2)


def group_count(images, per):
    """Groups of a sum over ``images`` images, ``per`` a group."""
    if not isinstance(per, int) or per <= 0:
        raise ValueError(f"per must be a positive int, got {per!r}")
    return -(-images // per)


def gemm_bf16_group_ref(a, b, per):
    """(groups, M, N) f32: partial g is the sum, in image order, of the f32
    products a[i] · b[i]ᵀ over the images i = g·per .. min((g+1)·per,
    images) − 1; a (images, M, K), b (images, N, K)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"want a (images, M, K) and b (images, N, K), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    images = a.shape[0]
    parts = []
    for g in range(group_count(images, per)):
        out = None
        for i in range(g * per, min((g + 1) * per, images)):
            p = torch.matmul(a[i].float(), b[i].float().t())
            out = p if out is None else out + p
        parts.append(out)
    return torch.stack(parts)


def gemm_s8_ref(a, b, rs, cs, *, chunk=None):
    """``(f32(a · bᵀ) · rs) · cs``: the integer product exact and rounded
    once to f32, then the row scale, then the column scale, each rounded in
    f32 (a, b: int8 or floats holding ints; a leading batch dimension
    broadcasts). With ``chunk`` (codes, dividing K): rs has one scale a
    (row, piece), (..., M, K // chunk), and the result is
    ``((0 + p_0) + p_1) + …``, p_i the dequantized product over the K
    columns i·chunk .. i·chunk + chunk − 1."""
    if chunk is None:
        acc = exact_int_matmul(a.float(), b.float().transpose(-1, -2))
        return acc * rs.float()[..., :, None] * cs.float()[..., None, :]
    K = a.shape[-1]
    if not isinstance(chunk, int) or chunk <= 0 or K % chunk:
        raise ValueError(f"chunk must be a positive int dividing K = {K}, got {chunk!r}")
    if rs.shape[-1] != K // chunk:
        raise ValueError(f"rs {tuple(rs.shape)}: want {K // chunk} scales a row, one a piece")
    out = 0.0
    for i, k0 in enumerate(range(0, K, chunk)):
        out = out + gemm_s8_ref(a[..., k0:k0 + chunk], b[..., k0:k0 + chunk], rs[..., i], cs)
    return out
