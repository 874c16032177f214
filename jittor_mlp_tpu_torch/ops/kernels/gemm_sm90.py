"""The Hopper GEMM core alone: its checking entries and their plain twins.

Kernel 1 (``mixer_block``) and the training forward (``mixer_block_bwd.fwd_with_h``)
run both channel products of the block on ``csrc/gemm_sm90.cuh``: TMA loads
into a 128-byte-swizzled shared-memory ring, ``wgmma`` from warp-specialized
warpgroups; the GELU product on its handoff schedule (one warpgroup's K
loops back to back, each tile's sums handed through shared memory to
epilogue warps that run under the next tile's ``wgmma``), the residual one
on its cooperative schedule (its header says what bounds each on an H100
and what the design does about that). The channel weight backward (``chan_wgt_bwd``) runs its
four products on the core's bf16 modes (MN-major operands, row slabs with
one f32 partial each), the channel data backward its two recompute
products, the bf16 gMLP and ResMLP blocks (``gmlp_block``,
``resmlp_block``) their three each (the GELU product and the token
product, a shared A and an N-major B an entry an image, on the handoff
schedule; the last product on the cooperative one), the W8A8 gMLP block
(``gmlp_block_int8``) its three products on the core's int8 form, and the
W8A8 Mixer block (``mixer_block_int8``) its four, the second in the int8
form's chunked mode. This module launches one product on its own
(``csrc/gemm_sm90.cu``), so that ``chip_smoke.py`` can hold each mode of the
core against its plain version and time it against the core it replaced
and the library. Nothing on the serving or training path calls it: it is an
instrument, like ``tools/kernel_lab.py``.

- ``gemm_tn(a, b, bias, act= | residual=)``: one Mixer channel product, for
  a (M, K), b (N, K) (a torch Linear weight) and bias (N,)::

      act="gelu_tanh":  out = bf16(gelu_tanh(a · bᵀ + bias))
      residual=R:       out = bf16(R + (a · bᵀ + bias)),  R (M, N)

  with f32 sums, the rounding points of ``GeluBias`` and ``ResidualBias``
  (``csrc/gemm_bf16.cuh``), which kernel 1 uses for these products.
- ``gemm_bf16(a, b, a_mn=, b_mn=, slab=)``: bf16 operands, a (M, K) or
  with ``a_mn`` (K, M), b (N, K) or with ``b_mn`` (K, N); the f32 partial
  products over K in row slabs of ``slab`` (all of K by default),
  (partials, M, N); or, where an operand has a leading batch dimension,
  one product an entry, (entries, M, N). A 2-D operand may be a view whose
  rows lie further apart than their width (the bf16 gMLP block's Wsp, in
  rows of round_up(N, 8)).
- ``gemm_bf16_dual(a1, b1, a2, b2, a_mn=, b_mn=)``: the dual mode (the
  Mixer token and channel data backwards): two products of one shape and
  reading, (v1, v2), each (entries, M, N) f32; each pair's operands batched
  or shared alike, the A's rows (and the B's) equally far apart.
- ``gemm_bf16_group(a, b, per)``: the Group mode (the token backward's
  weight gradients): a (images, M, K), b (images, N, K); one f32 partial
  a group of ``per`` images, (groups, M, N).
- ``gemm_s8(a, b, rs, cs, chunk=, gelu_bias=)``: int8 a (M, K) and b (N,
  K), each shared or one a batch entry (a leading dimension), f32 row
  scales rs and column scales cs; ``(f32(a · bᵀ) · rs) · cs`` in f32, the
  W8A8 dequantization; with ``chunk``, the chunked mode: K in pieces of
  ``chunk`` codes, rs (M, K // chunk) one scale a (row, piece), the
  pieces' dequantized products added in piece order; with ``gelu_bias``
  (N,) bf16 (2-D operands, no chunk), ``gelu_tanh(v + gelu_bias)`` in f32
  through the s8 core's GELU epilogue, which the W8A8 blocks' first
  products run: with exact sums, the kernels' shared GELU alone.

Each has its plain twin: ``gemm_tn_ref`` (the f32 product of the operands,
then the epilogue's arithmetic and one rounding to the operands' dtype; it
also takes ``act="gelu_erf"``, the float32 block's activation, which the
kernel does not), and from ``ops/products.py``, which the block twins
share, ``gemm_bf16_ref`` with ``sum_slabs_ref`` (the partials added in slab
order, as the backward adds them), ``gemm_bf16_dual_ref``,
``gemm_bf16_group_ref`` and ``gemm_s8_ref`` (the exact integer product, then
the scales in the kernel's order; with ``gelu_bias``, then the tanh-form
GELU, which the kernel evaluates as x·σ(2u) within the bound its header,
``csrc/common.cuh``, states).

- A CPU tensor goes to the twin; a contiguous CUDA tensor of the kernel's
  dtype launches the kernel on the current stream, on ``core`` ``"auto"``
  (the wgmma core where TMA can load both operands, else the core it
  replaced; int8 always the wgmma core, which loads every operand the
  mma.sync core took), ``"sm90"`` (the wgmma core, or raise) or
  ``"legacy"`` (the core it replaced: WMMA for bf16, mma.sync for int8;
  ``Core::Legacy`` in C); ``gemm_tn`` and ``gemm_bf16`` (a K-major a) also
  on ``"handoff"`` (the wgmma core on the handoff schedule, which kernel
  1's GELU product and the gMLP and ResMLP blocks' GELU and token products
  run, or raise); anything else raises.
- ``LAUNCHES``: how many times the wrappers launched a kernel;
  ``routes()``: the bf16 products on each core (a dual launch is two),
  ``s8_routes()`` the int8 ones; ``mode_launches()``: the wgmma core's
  launches by mode; ``config()``: the core's tile, ring stages and shared
  memory, the dual mode's and the handoff schedule's.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ..products import (bf16_dims, gemm_bf16_dual_ref, gemm_bf16_group_ref, gemm_bf16_ref,
                        gemm_s8_ref, group_count, slab_rows, sum_slabs_ref)
from ._build import S8_ROUTES, Library
from .mixer_block import require_bf16_contiguous

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("gemm_sm90", ["gemm_sm90.cu"],
               {"gemm_tn_bf16": (5, 5), "gemm_bf16_f32": (3, 12), "gemm_s8_f32": (5, 10),
                "gemm_s8_gelu_f32": (6, 4), "gemm_bf16_dual_f32": (5, 11),
                "gemm_bf16_group_f32": (3, 6)},
               error="gemm_error_string",
               queries={"gemm_sm90_config": 1, "gemm_mode_launches": 1},
               routes="gemm_tn_products")
CORES = {"auto": 0, "sm90": 1, "legacy": 2}
# gemm_tn's and gemm_bf16's cores: also the wgmma core on the handoff
# schedule, which kernel 1's GELU product and the gMLP and ResMLP blocks'
# GELU and token products run (the others run the cooperative one)
TN_CORES = {**CORES, "handoff": 3}
MODES = {"plain": 0, "chunked": 1, "dual": 2, "group": 3, "handoff": 4}
_ACTS = {"gelu_tanh": gelu_tanh, "gelu_erf": gelu_erf}


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90": n, "wmma": n}: the bf16 products these entries launched on
    each core."""
    return _LIB.routes()


def s8_routes():
    """{"sm90_s8": n, "mma_s8": n}: the int8 products these entries launched
    on each core."""
    return _LIB.routes(S8_ROUTES)


def mode_launches():
    """{mode: n}: the wgmma core's launches by these entries so far, by mode
    (MODES); zeros if the library is not loaded."""
    if not _LIB.loaded:
        return dict.fromkeys(MODES, 0)
    return {k: _LIB.query("gemm_mode_launches", v) for k, v in MODES.items()}


def config():
    """The wgmma core's block tile, K step, ring stages and dynamic shared
    memory in bytes, then the dual mode's tile width (K-major B), stages and
    shared memory, then the handoff schedule's tile, stages, epilogue warps
    and shared memory, as compiled."""
    keys = ("tile_m", "tile_n", "tile_k", "stages", "smem_bytes", "dual_tile_n", "dual_stages",
            "dual_smem_bytes", "handoff_tile_m", "handoff_tile_n", "handoff_stages",
            "handoff_epilogue_warps", "handoff_smem_bytes")
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
    contiguous, ``act`` "gelu_tanh" or a residual) on ``core`` (one of
    ``TN_CORES``: "handoff" is the wgmma core on the handoff schedule,
    the others run the cooperative one), launched on the current stream; it
    raises on anything it does not take and never falls back to the twin."""
    M, N, K = _args(a, b, bias, act, residual)
    _check_core(core, TN_CORES)
    if a.device.type == "cpu":
        return gemm_tn_ref(a, b, bias, act=act, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    if act not in (None, "gelu_tanh"):
        raise ValueError(f"the kernel's activation is gelu_tanh, got {act!r}")
    require_bf16_contiguous((a, b, bias) + (() if residual is None else (residual,)))
    return _launch_tn(a, b, bias, residual, core)


def _launch_tn(a, b, bias, residual, core):
    """gemm_tn's launch: the output (M, N), bf16, on a's device."""
    (M, K), N = a.shape, b.shape[0]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    r = out if residual is None else residual  # read only with a residual
    _LIB.launch("gemm_tn_bf16", a.device, (a, b, bias, r, out),
                (M, N, K, 0 if residual is None else 1, TN_CORES[core]))
    _count()
    return out


def _count():
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _check_core(core, cores=CORES):
    if core not in cores:
        raise ValueError(f"core must be one of {sorted(cores)}, got {core!r}")


def gemm_bf16(a, b, *, a_mn=False, b_mn=False, slab=None, core="auto"):
    """The core's bf16 modes: f32 partial products (partials, M, N), or one
    product an entry (entries, M, N) where an operand is batched. CPU: the
    plain twin. CUDA: the kernel (bf16, contiguous) on ``core``, launched on
    the current stream; it raises on anything it does not take and never
    falls back to the twin."""
    nb, M, N, K = bf16_dims(a, b, a_mn, b_mn, slab)
    _check_core(core, TN_CORES)
    if core == "handoff" and a_mn:
        raise ValueError("the handoff schedule reads a K-major a")
    if a.device.type == "cpu":
        return gemm_bf16_ref(a, b, a_mn=a_mn, b_mn=b_mn, slab=slab)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    _bf16_kernel_operands(a, b)
    parts, step = slab_rows(K, slab)
    out = torch.empty((max(parts, nb), M, N), dtype=torch.float32, device=a.device)
    _LIB.launch("gemm_bf16_f32", a.device, (a, b, out),
                (nb, M, N, K, a.stride(-2), b.stride(-2), step, int(a_mn), int(b_mn),
                 int(a.dim() == 3), int(b.dim() == 3), TN_CORES[core]))
    _count()
    return out


def _bf16_kernel_operands(*ts):
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bf16 operands, got {t.dtype}")
        if not (t.is_contiguous() or (t.dim() == 2 and t.stride(1) == 1)):
            raise ValueError(f"want contiguous operands, or 2-D ones with contiguous rows; got "
                             f"strides {t.stride()}")


def gemm_bf16_dual(a1, b1, a2, b2, *, a_mn=False, b_mn=False, core="auto"):
    """The core's dual mode: (v1, v2), v1 = op(a1)·op(b1) and v2 =
    op(a2)·op(b2), each (entries, M, N) f32. CPU: the plain twin. CUDA: the
    kernel (bf16; both A's, and both B's, of one layout: batched or shared
    alike, rows equally far apart) on ``core``, launched on the current
    stream; it raises on anything it does not take and never falls back to
    the twin."""
    nb, M, N, K = bf16_dims(a1, b1, a_mn, b_mn, None)
    if bf16_dims(a2, b2, a_mn, b_mn, None) != (nb, M, N, K):
        raise ValueError("the two products differ in shape")
    for x, y, name in ((a1, a2, "A"), (b1, b2, "B")):
        if x.shape != y.shape or x.stride() != y.stride() or x.device != y.device:
            raise ValueError(f"the two {name} operands differ in shape, strides or device")
    _check_core(core)
    if a1.device.type == "cpu":
        return gemm_bf16_dual_ref(a1, b1, a2, b2, a_mn=a_mn, b_mn=b_mn)
    if a1.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a1.device}")
    _bf16_kernel_operands(a1, b1, a2, b2)
    out = torch.empty((2, nb, M, N), dtype=torch.float32, device=a1.device)
    _LIB.launch("gemm_bf16_dual_f32", a1.device, (a1, b1, a2, b2, out),
                (nb, M, N, K, a1.stride(-2), b1.stride(-2), int(a_mn), int(b_mn),
                 int(a1.dim() == 3), int(b1.dim() == 3), CORES[core]))
    _count()
    return out[0], out[1]


def gemm_bf16_group(a, b, per, *, core="auto"):
    """The core's Group mode: (groups, M, N) f32, partial g the sum over
    images g·per .. of a[i]·b[i]ᵀ, a (images, M, K), b (images, N, K). CPU:
    the plain twin. CUDA: the kernel (bf16, contiguous) on ``core``,
    launched on the current stream; it raises on anything it does not take
    and never falls back to the twin."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"want a (images, M, K) and b (images, N, K), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"operands on {b.device} and {a.device}")
    if b.dtype != a.dtype or not a.is_floating_point():
        raise TypeError(f"want floating-point operands of one dtype, got {a.dtype}, {b.dtype}")
    images, M, K = a.shape
    groups = group_count(images, per)
    _check_core(core)
    if a.device.type == "cpu":
        return gemm_bf16_group_ref(a, b, per)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    _bf16_kernel_operands(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the Group mode takes contiguous operands")
    out = torch.empty((groups, M, b.shape[1]), dtype=torch.float32, device=a.device)
    _LIB.launch("gemm_bf16_group_f32", a.device, (a, b, out),
                (images, per, M, b.shape[1], K, CORES[core]))
    _count()
    return out


def _s8_args(a, b, rs, cs, chunk):
    """(entries, M, N, K, which of a, b, rs, cs have a batch dimension)."""
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"want a (M, K) or (Z, M, K), b (N, K) or (Z, N, K); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    M, K = a.shape[-2:]
    N, Kb = b.shape[-2:]
    nz = max(a.shape[0] if a.dim() == 3 else 1, b.shape[0] if b.dim() == 3 else 1)
    if Kb != K:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not share K")
    if chunk is not None and (not isinstance(chunk, int) or chunk <= 0 or chunk % 32 or K % chunk):
        raise ValueError(f"chunk must be a multiple of 32 that divides K = {K}, got {chunk!r}")
    want_rs = (M,) if chunk is None else (M, K // chunk)
    batched = []
    for name, t, want in (("a", a, (M, K)), ("b", b, (N, K)), ("rs", rs, want_rs), ("cs", cs, (N,))):
        if tuple(t.shape) not in (want, (nz, *want)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want} or {(nz, *want)}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        batched.append(int(t.dim() > len(want)))
    return nz, M, N, K, tuple(batched)


def gemm_s8(a, b, rs, cs, *, chunk=None, gelu_bias=None, core="auto"):
    """The core's int8 form: (M, N) f32, or (Z, M, N) where an operand has a
    batch dimension; with ``chunk``, its chunked mode; with ``gelu_bias``,
    its GELU epilogue. CPU: the plain twin. CUDA: the kernel (int8 operands
    with K a multiple of 32, f32 scales, a bf16 bias, contiguous) on
    ``core``, launched on the current stream; it raises on anything it does
    not take and never falls back to the twin."""
    nz, M, N, K, batched = _s8_args(a, b, rs, cs, chunk)
    _check_core(core)
    if gelu_bias is not None and (any(batched) or chunk is not None or
                                  tuple(gelu_bias.shape) != (N,) or
                                  gelu_bias.device != a.device):
        raise ValueError(f"gelu_bias takes 2-D operands, no chunk, and a bias of ({N},) on "
                         f"{a.device}; got {tuple(gelu_bias.shape)} on {gelu_bias.device}")
    if a.device.type == "cpu":
        out = gemm_s8_ref(a, b, rs, cs, chunk=chunk)
        return out if gelu_bias is None else gelu_tanh(out + gelu_bias.float())
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    for t, dt in ((a, torch.int8), (b, torch.int8), (rs, torch.float32), (cs, torch.float32)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"the int8 kernel takes contiguous int8 operands and f32 scales, "
                            f"got {t.dtype}")
    if K % 32:
        raise ValueError(f"K must be a multiple of 32 (zero-padded codes), got {K}")
    if gelu_bias is not None:
        if gelu_bias.dtype != torch.bfloat16 or not gelu_bias.is_contiguous():
            raise TypeError(f"gelu_bias must be contiguous bf16, got {gelu_bias.dtype}")
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
        _LIB.launch("gemm_s8_gelu_f32", a.device, (a, b, rs, cs, gelu_bias, out),
                    (M, N, K, CORES[core]))
        _count()
        return out
    out = torch.empty((nz, M, N), dtype=torch.float32, device=a.device)
    _LIB.launch("gemm_s8_f32", a.device, (a, b, rs, cs, out),
                (nz, M, N, K, chunk or 0, *batched, CORES[core]))
    _count()
    return out if any(batched) else out[0]
