"""The kernel lab's Mixer-block variants: four CUDA kernels, their plain twins, the wrappers.

Replaces the Pallas TPU kernels of ``tools/kernel_lab.py``: ``_call_tokmajor``
(body ``_kernel_tokmajor``) and ``_call`` with its three bodies
(``_kernel_wide``, ``_kernel_noscratch``, ``_make_kernel_ablate``). Each
computes the Mixer block of ``mixer_block.py`` with the weights in their
torch layouts (wt1 (TD, N), wt2 (N, TD), wc1 (CD, D), wc2 (D, CD)), and
differs from kernel 1 (``mixer_block_ref``) only where its body does:

- ``tokmajor_block(x, *w, bt)`` (``csrc/lab_tokmajor.cu``): x and the output
  are token-major, (G, N, bt, D) with G = B / bt (``to_tokmajor`` /
  ``from_tokmajor`` relayout a (B, N, D) stack once before and once after).
  Both token products are one (N, bt·D) product per group. h = x + t2 + bt2
  in that order; LN2 reads the f32 h, the output residual adds the bf16 h.
- ``wide_block(x, *w, bt)`` (``csrc/lab_wide.cu``): x (B, N, D). LN1 writes
  a group-major (G, N, bt·D) buffer and the token products run once per
  group of bt images at width bt·D; h = x + (t2 + bt2), the bias added to
  t2 first; LN2 reads the bf16 h.
- ``noscratch_block(x, *w, bt)``: the exact-erf GELU in both mixes for every
  dtype; h lives in the output buffer and the channel residual updates it in
  place. On the card it is the ablate kernel at (exact, LN on) with the
  output buffer passed as its h: that is the body's whole computation.
- ``ablate_block(x, *w, bt, gelu, ln)`` (``csrc/lab_ablate.cu``): GELU
  ``exact``, ``fast3`` (the A&S 7.1.25 3-term erf), ``tanh`` or ``relu``; LN
  on, or off (xn = x and hn = bf16 h, no statistics, no affine). The lab's
  five ablations are ``relu_skel`` (relu, LN), ``noln_skel`` (exact, no LN),
  ``matmul_skel`` (relu, no LN), ``gelu_fast3`` and ``gelu_tanh`` (LN).

Where not stated otherwise the activation is the exact GELU for float32 and
the tanh form for bf16 (the JAX ``_act_for``), and h = x + t2 + bt2.

``bt`` changes the computation on the card only for ``tokmajor_block`` (the
layout) and ``wide_block`` (the width of the token product). The
``noscratch_block`` and ``ablate_block`` kernels do not depend on it: the
wrappers accept and check it (B % bt == 0), so the lab's ``noscratch2`` and
``noscratch4`` are one kernel run twice.

Each wrapper takes a CPU tensor to its twin (``*_ref``: plain PyTorch with
the body's rounding points and addition order), launches its kernel on the
current stream for a contiguous bf16 CUDA tensor, and raises on anything
else. Every kernel runs its four products through kernel 1's code: the token
pair through ``mixer_forward.cuh``'s ``token_products`` (Wt1 copied into
rows of round_up(N, 8), a scratch each wrapper gives, as
``mixer_block.forward_scratch`` does for kernel 1), the channel pair through
``gemm_tn``. ``LAUNCHES`` counts kernel launches per wrapper, ``routes()``
their products per GEMM core.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ._build import Library
from .mixer_block import block_dims, layer_norm_f32, require_bf16_contiguous

LAUNCHES = {"tokmajor_block": 0, "wide_block": 0, "noscratch_block": 0, "ablate_block": 0}
_COUNT_LOCK = threading.Lock()
_LIBS = {
    "tokmajor_block": Library("lab_tokmajor", ["lab_tokmajor.cu"], {"lab_tokmajor_bf16": (20, 6)},
                              error="lab_error_string", routes="lab_tokmajor_gemm_products"),
    "wide_block": Library("lab_wide", ["lab_wide.cu"], {"lab_wide_bf16": (19, 6)},
                          error="lab_error_string", routes="lab_wide_gemm_products"),
    "ablate_block": Library("lab_ablate", ["lab_ablate.cu"], {"lab_ablate_bf16": (19, 7)},
                            error="lab_error_string", routes="lab_ablate_gemm_products"),
}
_LIBS["noscratch_block"] = _LIBS["ablate_block"]
GELUS = ("exact", "fast3", "tanh", "relu")  # the ablate kernel's activation codes, in order


def build():
    """Compile (if needed) and load the three kernel libraries, one nvcc each, at once."""
    libs = set(_LIBS.values())
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))


def routes():
    """{"sm90": n, "wmma": n}: the lab kernels' products so far on each
    GEMM core (csrc/gemm_sm90.cuh), summed over the three libraries: four a
    launch, each on the wgmma core where TMA can load its operands, else on
    the WMMA core. With W the token products' width (bt·D for the wide and
    token-major kernels, D for the others): the first token product where
    W % 8 == 0, the second where W % 8 == 0 and TD % 8 == 0, the channel
    products where D % 8 == 0, and where CD % 8 == 0."""
    counts = [lib.routes() for lib in set(_LIBS.values())]
    return {r: sum(c[r] for c in counts) for r in counts[0]}


def gelu_fast3(z):
    """GELU with the A&S 7.1.25 3-term erf (the lab's ``fast3``)."""
    a = z.abs() * 0.7071067811865476
    t = 1.0 / (1.0 + 0.47047 * a)
    poly = t * (0.3480242 + t * (-0.0958798 + t * 0.7478556))
    return 0.5 * z * (1.0 + torch.sign(z) * (1.0 - poly * torch.exp(-a * a)))


_ACTS = {"exact": gelu_erf, "fast3": gelu_fast3, "tanh": gelu_tanh,
         "relu": lambda z: torch.clamp_min(z, 0.0)}


def _lab_ref(x, w, act, ln=True, bias_first=False, ln2_f32=False):
    """One block on x (B, N, D): products in f32, rounding to x's dtype where
    the bodies round. ``bias_first``: h = x + (t2 + bt2), else (x + t2) + bt2;
    ``ln2_f32``: LN2 reads the f32 h, else the rounded h; ``ln`` off: the
    products read x and h themselves."""
    ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2 = w
    dt = x.dtype
    xn = layer_norm_f32(x, ln1w, ln1b).to(dt) if ln else x
    t = act(torch.matmul(wt1.float(), xn.float()) + bt1.float()[:, None]).to(dt)
    t2 = torch.matmul(wt2.float(), t.float())
    if bias_first:
        hf = x.float() + (t2 + bt2.float()[:, None])
    else:
        hf = x.float() + t2 + bt2.float()[:, None]
    h = hf.to(dt)
    hn = layer_norm_f32(hf if ln2_f32 else h, ln2w, ln2b).to(dt) if ln else h
    c = act(torch.matmul(hn.float(), wc1.float().t()) + bc1.float()).to(dt)
    c2 = torch.matmul(c.float(), wc2.float().t()) + bc2.float()
    return (h.float() + c2).to(dt)


def _act_for(dtype):
    return gelu_erf if dtype == torch.float32 else gelu_tanh


def to_tokmajor(x, bt):
    """(B, N, D) → (B/bt, N, bt, D), contiguous (the JAX ``_to_tokmajor``)."""
    B, n, d = x.shape
    return x.reshape(B // bt, bt, n, d).permute(0, 2, 1, 3).contiguous()


def from_tokmajor(x):
    """(G, N, bt, D) → (G·bt, N, D), contiguous (the JAX ``_from_tokmajor``)."""
    G, n, bt, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(G * bt, n, d)


def tokmajor_block_ref(x, *w, bt):
    """Twin of ``_kernel_tokmajor`` on x (G, N, bt, D)."""
    y = _lab_ref(from_tokmajor(x), w, _act_for(x.dtype), ln2_f32=True)
    return to_tokmajor(y, bt)


def wide_block_ref(x, *w, bt):
    """Twin of ``_kernel_wide`` on x (B, N, D)."""
    return _lab_ref(x, w, _act_for(x.dtype), bias_first=True)


def noscratch_block_ref(x, *w, bt):
    """Twin of ``_kernel_noscratch`` on x (B, N, D)."""
    return _lab_ref(x, w, gelu_erf)


def ablate_block_ref(x, *w, bt, gelu, ln):
    """Twin of ``_make_kernel_ablate(gelu, ln)`` on x (B, N, D)."""
    return _lab_ref(x, w, _ACTS[gelu], ln=ln)


def _check(x, weights, bt, tokmajor=False):
    """Check x, the weights and bt; return (B, N, D, TD, CD) of the block."""
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if not isinstance(bt, int) or bt < 1:
        raise ValueError(f"bt must be a positive int, got {bt!r}")
    if tokmajor:
        if x.dim() != 4 or x.shape[2] != bt:
            raise ValueError(f"x must be (G, N, bt={bt}, D), got shape {tuple(x.shape)}")
        G, N, _, D = x.shape
        _, _, _, TD, CD = block_dims(x[:, :, 0], weights)
        return G * bt, N, D, TD, CD
    B, N, D, TD, CD = block_dims(x, weights)
    if B % bt:
        raise ValueError(f"batch {B} is not a multiple of bt={bt}")
    return B, N, D, TD, CD


def _device(x):
    """'cpu' or 'cuda' for x's device; raise for any other."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel-lab kernel for device {x.device}")
    return x.device.type


def _wt1p(N, TD):
    """The token products' copy of Wt1: (TD, round_up(N, 8)), rows a TMA
    load can stride."""
    return (TD, -(-N // 8) * 8), torch.bfloat16


def _launch(name, entry, x, weights, scratch, ints):
    """Launch ``entry`` of wrapper ``name``'s library on x's current stream
    with fresh scratch buffers (shape, dtype), None standing for the output
    buffer, and a fresh output; count it."""
    require_bf16_contiguous((x, *weights))
    out = torch.empty_like(x)
    bufs = [out if s is None else torch.empty(s[0], dtype=s[1], device=x.device)
            for s in scratch]
    _LIBS[name].launch(entry, x.device, (x, *weights, *bufs, out), ints)
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    return out


def tokmajor_block(x, *weights, bt):
    """The token-major block on x (G, N, bt, D). CPU: the twin. CUDA: the
    kernel (bf16, contiguous); it raises on anything it does not take."""
    B, N, D, TD, CD = _check(x, weights, bt, tokmajor=True)
    if _device(x) == "cpu":
        return tokmajor_block_ref(x, *weights, bt=bt)
    bf, f32 = torch.bfloat16, torch.float32
    scratch = [((B, N, D), bf), ((B, TD, D), bf), _wt1p(N, TD), ((B, N, D), bf),
               ((B, N, D), f32), ((B * N, CD), bf)]  # xn (then hn), t, Wt1's copy, h, f32 h, c
    return _launch("tokmajor_block", "lab_tokmajor_bf16", x, weights, scratch,
                   (B // bt, N, bt, D, TD, CD))


def wide_block(x, *weights, bt):
    """The wide-token-product block on x (B, N, D). CPU: the twin. CUDA: the
    kernel (bf16, contiguous); it raises on anything it does not take."""
    B, N, D, TD, CD = _check(x, weights, bt)
    if _device(x) == "cpu":
        return wide_block_ref(x, *weights, bt=bt)
    bf = torch.bfloat16
    scratch = [((B, N, D), bf), ((B, TD, D), bf), _wt1p(N, TD), ((B, N, D), bf),
               ((B * N, CD), bf)]  # group-major xn (then hn), t, Wt1's copy, h, c
    return _launch("wide_block", "lab_wide_bf16", x, weights, scratch, (B, N, D, TD, CD, bt))


def noscratch_block(x, *weights, bt):
    """The no-scratch block on x (B, N, D). CPU: the twin. CUDA: the ablate
    kernel at (exact, LN on) with h in the output buffer (bf16, contiguous);
    it raises on anything it does not take."""
    B, N, D, TD, CD = _check(x, weights, bt)
    if _device(x) == "cpu":
        return noscratch_block_ref(x, *weights, bt=bt)
    bf = torch.bfloat16
    scratch = [((B, N, D), bf), ((B, TD, D), bf), _wt1p(N, TD), None,
               ((B * N, CD), bf)]  # xn (then hn), t, Wt1's copy, h = the output, c
    return _launch("noscratch_block", "lab_ablate_bf16", x, weights, scratch,
                   (B, N, D, TD, CD, GELUS.index("exact"), 1))


def ablate_block(x, *weights, bt, gelu, ln):
    """An ablated block on x (B, N, D): GELU ``gelu`` (one of GELUS), LN on
    or off. CPU: the twin. CUDA: the kernel (bf16, contiguous); it raises on
    anything it does not take."""
    if gelu not in GELUS:
        raise ValueError(f"gelu must be one of {GELUS}, got {gelu!r}")
    B, N, D, TD, CD = _check(x, weights, bt)
    if _device(x) == "cpu":
        return ablate_block_ref(x, *weights, bt=bt, gelu=gelu, ln=ln)
    bf = torch.bfloat16
    scratch = [((B, N, D), bf), ((B, TD, D), bf), _wt1p(N, TD), ((B, N, D), bf),
               ((B * N, CD), bf)]  # xn (then hn), t, Wt1's copy, h, c
    return _launch("ablate_block", "lab_ablate_bf16", x, weights, scratch,
                   (B, N, D, TD, CD, GELUS.index(gelu), int(bool(ln))))
