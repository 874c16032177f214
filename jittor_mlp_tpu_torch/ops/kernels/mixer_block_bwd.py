"""Mixer block training on the kernel route: the forward that also hands
back h, the three backward kernels, their plain twins and the wrappers.

Replaces ``jittor_mlp_tpu/ops/pallas/mixer_block_bwd.py`` (``_fwd_with_h``,
``_token_bwd``, ``_chan_data_bwd``, ``_chan_wgt_bwd`` and the custom VJP
``fused_mixer_block_train``). The kernel source is
``csrc/mixer_block_bwd.cu`` (its header gives the math, the rounding
points and what bounds each entry on an H100). The wrappers take the JAX
signatures without the TPU tiling arguments ``bt`` / ``ck``:

    fwd_with_h(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2)
        -> (out, h)
    token_bwd(x, dh, ln1w, ln1b, wt1, bt1, wt2)
        -> (dx, dwt1, dwt2, dbt1, dln1w, dln1b)
    chan_data_bwd(h, g, ln2w, ln2b, bc1, wc1, wc2) -> (dh, dln2w, dln2b)
    chan_wgt_bwd(h, g, ln2w, ln2b, bc1, wc1, wc2)  -> (dwc1, dwc2, dbc1)

dx and dh come in the input dtype, every weight, bias and LayerNorm
gradient in float32, in the torch layouts (dwt1 (TD, N), dwt2 (N, TD),
dwc1 (CD, D), dwc2 (D, CD)).

- ``*_ref``: the plain twins, written from the Pallas kernel bodies with
  their rounding points (``dh`` and ``g`` in the input dtype, ``dtp`` and
  ``dcp`` cast to it before their products) and without the TPU padding of
  N to 128. For float32 inputs they use the exact-erf GELU and its
  derivative, as the Pallas kernels do.
- A CPU tensor runs the twin; a CUDA bf16 contiguous tensor launches the
  kernel; anything else raises.
- ``LAUNCHES``: launches per wrapper, by name; ``routes()``: the products
  on each bf16 GEMM core of the forward (four a launch), the token backward
  (five: a dual product, two group sums, dxn), the channel data backward
  (three: a dual product, dhn) and the channel weight backward (four);
  ``mode_launches()``: the wgmma core's launches by mode.
- ``images_per_group``: how many images each f32 partial of a weight
  gradient sums on the card (set by the device's multiprocessor count).
  ``token_bwd_ref`` takes it as ``images_per_group`` and
  ``chan_wgt_bwd_ref`` as ``images_per_slab``, and each adds its partials
  in order, as the kernels do; by default one partial.
- The twins of the token and channel data backwards are built from the
  core's twins (``ops/products.py``) on the kernels' layouts: the dual
  product's ``gemm_bf16_dual_ref`` with the kernel's epilogue (dbt1 summed
  from partials of eight columns, as the kernel sums it), the group sums'
  ``gemm_bf16_group_ref``.
- ``fused_mixer_block_train``: the kernel route's ``autograd.Function``,
  the JAX ``_train_fwd`` / ``_train_bwd``: ``fwd_with_h`` forward saving x
  and h; backward ``chan_data_bwd``, ``chan_wgt_bwd``, ``token_bwd``, with
  ``dbc2 = Σ g`` and ``dbt2 = Σ dh`` as f32 sums, each gradient cast to
  its input's dtype.
"""

from __future__ import annotations

import functools
import math
import threading

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ..products import gemm_bf16_dual_ref, gemm_bf16_group_ref, gemm_bf16_ref, sum_slabs_ref
from ._build import Library
from .mixer_block import (block_dims, check_weights, forward_scratch, mixer_block_ref,
                          require_bf16_contiguous)

LAUNCHES = {"fwd_with_h": 0, "token_bwd": 0, "chan_data_bwd": 0, "chan_wgt_bwd": 0}
_COUNT_LOCK = threading.Lock()
_LIB = Library(
    "mixer_block_bwd", ["mixer_block_bwd.cu"],
    {"mixer_fwd_with_h_bf16": (19, 5), "mixer_token_bwd_bf16": (14, 5),
     "mixer_chan_data_bwd_bf16": (11, 4), "mixer_chan_wgt_bwd_bf16": (11, 5)},
    error="mixer_bwd_error_string",
    workspace={"mixer_token_bwd_workspace": 5, "mixer_chan_data_bwd_workspace": 4,
               "mixer_chan_wgt_bwd_workspace": 5, "mixer_token_bwd_images_per_group": 5,
               "mixer_chan_wgt_bwd_images_per_group": 5},
    queries={"mixer_bwd_mode_launches": 1}, routes="mixer_bwd_gemm_products")
# the wgmma core's launch modes this library runs (fwd_with_h's GELU channel
# product on the handoff schedule)
MODES = {"plain": 0, "dual": 2, "group": 3, "handoff": 4}

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_TANH_C = math.sqrt(2.0 / math.pi)


def gelu_erf_grad(x):
    """d/dx of the exact-erf GELU: Φ(x) + x·φ(x)."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) + x * _INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def gelu_tanh_grad(x):
    """d/dx of the tanh-form GELU."""
    t = torch.tanh(_TANH_C * (x + 0.044715 * x * x * x))
    du = _TANH_C * (1.0 + 3.0 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _act(dtype):
    """(activation, its derivative) of the kernels for inputs of ``dtype``."""
    return (gelu_erf, gelu_erf_grad) if dtype == torch.float32 else (gelu_tanh, gelu_tanh_grad)


def _ln_stats(x, eps=1e-5):
    """f32 (x̂, inv σ) of the last axis."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    return (xf - mu) * inv, inv


def _ln_bwd(dxn, xhat, inv, w):
    """LayerNorm input gradient from the gradient dxn of its output."""
    dy = dxn * w.float()
    m1 = dy.mean(-1, keepdim=True)
    m2 = (dy * xhat).mean(-1, keepdim=True)
    return inv * (dy - m1 - xhat * m2)


def fwd_with_h_ref(x, *weights):
    """Twin of ``fwd_with_h``: kernel 1's twin, with h."""
    return mixer_block_ref(x, *weights, with_h=True)


def _run_sums(d):
    """Partials of a (..., D) tensor: the sums of its runs of eight columns
    (the last run may be shorter), each in column order, (..., ceil(D/8))."""
    D = d.shape[-1]
    d = torch.nn.functional.pad(d, (0, -D % 8))
    out = d[..., 0::8]
    for e in range(1, 8):
        out = out + d[..., e::8]
    return out


def token_bwd_ref(x, dh, ln1w, ln1b, wt1, bt1, wt2, images_per_group=None):
    """Twin of ``token_bwd`` (the Pallas ``_token_bwd_kernel``), on the
    kernel's layout: one dual product an image (Wt1 and Wt2ᵀ shared, xn and
    dh N-major) with the epilogue tp = v1 + bt1, t = act(tp), d =
    v2·act'(tp) and dbt1's partials of eight columns; dWt2 and dWt1 summed
    over images in groups of ``images_per_group`` (all by default), the
    partials added in order; dxn = Wt1ᵀ·dtp an image."""
    dt = x.dtype
    act, act_grad = _act(dt)
    xhat, inv = _ln_stats(x)
    xn = (xhat * ln1w.float() + ln1b.float()).to(dt)
    dh = dh.to(dt)

    def epi(v1, v2):
        tp = v1 + bt1.float()[:, None]
        d = v2 * act_grad(tp)
        return act(tp).to(dt), d.to(dt), _run_sums(d).sum(-1).sum(0)

    t, dtp, dbt1 = gemm_bf16_dual_ref(wt1, xn, wt2.t(), dh, epi, b_mn=True)
    per = images_per_group or x.shape[0]
    dwt2 = sum_slabs_ref(gemm_bf16_group_ref(dh, t, per))
    dwt1 = sum_slabs_ref(gemm_bf16_group_ref(dtp, xn, per))
    dxn = gemm_bf16_ref(wt1, dtp, a_mn=True, b_mn=True)
    dx = (dh.float() + _ln_bwd(dxn, xhat, inv, ln1w)).to(dt)
    return dx, dwt1, dwt2, dbt1, (dxn * xhat).sum((0, 1)), dxn.sum((0, 1))


def _chan_recompute(h, g, ln2w, ln2b, bc1, wc1, wc2):
    """The channel kernels' shared start: x̂, inv, hn, cp = hn·Wc1ᵀ + bc1,
    g in the input dtype, dc·act'(cp) with dc = g·Wc2 (all f32)."""
    dt = h.dtype
    _, act_grad = _act(dt)
    xhat, inv = _ln_stats(h)
    hn = (xhat * ln2w.float() + ln2b.float()).to(dt).float()
    cp = torch.matmul(hn, wc1.float().t()) + bc1.float()
    gf = g.to(dt).float()
    dcp = torch.matmul(gf, wc2.float()) * act_grad(cp)
    return xhat, inv, hn, cp, gf, dcp


def chan_data_bwd_ref(h, g, ln2w, ln2b, bc1, wc1, wc2):
    """Twin of ``chan_data_bwd`` (the Pallas ``_chan_data_kernel``; its
    chunking of CD only fits VMEM: one product here), on the kernel's
    layout: one dual product over the B·N rows, v1 = hn·Wc1ᵀ and v2 = g·Wc2
    (Wc2ᵀ K-major), dcp = v2·act'(v1 + bc1) in the input dtype; then dhn =
    dcp·Wc1 (Wc1 N-major) and the LayerNorm backward."""
    dt = h.dtype
    _, act_grad = _act(dt)
    B, N, D = h.shape
    xhat, inv = _ln_stats(h)
    hn = (xhat * ln2w.float() + ln2b.float()).to(dt).reshape(B * N, D)
    gr = g.to(dt).reshape(B * N, D)
    dcp = gemm_bf16_dual_ref(hn, wc1, gr, wc2.t(),
                             lambda v1, v2: (v2 * act_grad(v1 + bc1.float())).to(dt))
    dhn = gemm_bf16_ref(dcp[0], wc1, b_mn=True)[0].reshape(B, N, D)
    dh = (gr.float().reshape(B, N, D) + _ln_bwd(dhn, xhat, inv, ln2w)).to(dt)
    return dh, (dhn * xhat).sum((0, 1)), dhn.sum((0, 1))


def chan_wgt_bwd_ref(h, g, ln2w, ln2b, bc1, wc1, wc2, images_per_slab=None):
    """Twin of ``chan_wgt_bwd`` (the Pallas ``_chan_wgt_kernel``): dWc1 =
    dcpᵀ·hn and dWc2 = gᵀ·c over the B·N rows, both operands MN-major, in
    slabs of ``images_per_slab`` images (all by default) whose f32 partials
    are added in order."""
    act, _ = _act(h.dtype)
    _, _, hn, cp, gf, dcp = _chan_recompute(h, g, ln2w, ln2b, bc1, wc1, wc2)
    c = act(cp).to(h.dtype).float()
    dbc1 = dcp.sum((0, 1))
    dcp = dcp.to(h.dtype).float()
    B, N, D = h.shape
    slab = (images_per_slab or B) * N

    def rows(t):
        return t.reshape(B * N, -1)

    dwc1 = sum_slabs_ref(gemm_bf16_ref(rows(dcp), rows(hn), a_mn=True, b_mn=True, slab=slab))
    dwc2 = sum_slabs_ref(gemm_bf16_ref(rows(gf), rows(c), a_mn=True, b_mn=True, slab=slab))
    return dwc1, dwc2, dbc1


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90": n, "wmma": n}: the products so far on each bf16 GEMM core
    (csrc/gemm_sm90.cuh) of ``fwd_with_h`` (four a launch), ``token_bwd``
    (five), ``chan_data_bwd`` (three) and ``chan_wgt_bwd`` (four); a dual
    product counts as two."""
    return _LIB.routes()


def mode_launches():
    """{mode: n}: the wgmma core's launches so far by mode ("plain": one
    product, "dual": the dual mode, "group": the Group mode, "handoff": one
    product on the handoff schedule); zeros if the library is not
    loaded."""
    if not _LIB.loaded:
        return dict.fromkeys(MODES, 0)
    return {k: _LIB.query("mixer_bwd_mode_launches", v) for k, v in MODES.items()}


def _device(x, what):
    """'cpu' or 'cuda' for x's device; raise for any other."""
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    return x.device.type


def _launch(name, entry, x, tensors, ints):
    _LIB.launch(entry, x.device, tensors, ints)
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _f32(*shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=None)
def _sms(index):
    """Multiprocessor count of CUDA device ``index``: it sets how many images
    each f32 partial of the weight-gradient sums takes, so it is fixed per
    device and two calls agree bit for bit."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(entry, x, *dims):
    return torch.empty(_LIB.workspace(*dims, entry=entry), dtype=torch.uint8, device=x.device)


def images_per_group(name, x, inner):
    """Images in each f32 partial of the weight-gradient sums of kernel
    ``name`` ("token_bwd" with inner = TD, "chan_wgt_bwd" with inner = CD)
    for activations x (B, N, D) on the card, as the kernel groups them."""
    B, N, D = x.shape
    return _LIB.workspace(B, N, D, inner, _sms(x.device.index),
                          entry=f"mixer_{name}_images_per_group")


def _check_like(x, other, name):
    if other.shape != x.shape:
        raise ValueError(f"{name}: shape {tuple(other.shape)} != {tuple(x.shape)}")
    if other.device != x.device:
        raise ValueError(f"{name} is on {other.device}, x on {x.device}")


def fwd_with_h(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2):
    """Mixer block forward returning (out, h). CPU: the twin. CUDA: the
    kernel (bf16, contiguous); it raises on anything it does not take."""
    weights = (ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2)
    dev = _device(x, "mixer-block")
    B, N, D, TD, CD = block_dims(x, weights)
    if dev == "cpu":
        return fwd_with_h_ref(x, *weights)
    require_bf16_contiguous((x, *weights))
    scratch, out = forward_scratch(x, TD, CD), torch.empty_like(x)
    _launch("fwd_with_h", "mixer_fwd_with_h_bf16", x, (x, *weights, *scratch, out),
            (B, N, D, TD, CD))
    return out, scratch[3]


def token_bwd(x, dh, ln1w, ln1b, wt1, bt1, wt2):
    """Token-mix backward: (dx, dwt1, dwt2, dbt1, dln1w, dln1b). CPU: the
    twin. CUDA: the kernel (bf16, contiguous)."""
    dev = _device(x, "token-backward")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got shape {tuple(x.shape)}")
    B, N, D = x.shape
    TD = wt1.shape[0]
    _check_like(x, dh, "dh")
    weights = (ln1w, ln1b, wt1, bt1, wt2)
    check_weights(x, weights, ["ln1w", "ln1b", "wt1", "bt1", "wt2"],
                  [(D,), (D,), (TD, N), (TD,), (N, TD)])
    if dev == "cpu":
        return token_bwd_ref(x, dh, *weights)
    require_bf16_contiguous((x, dh, *weights))
    sms = _sms(x.device.index)
    ws = _workspace("mixer_token_bwd_workspace", x, B, N, D, TD, sms)
    outs = (torch.empty_like(x), _f32(TD, N, like=x), _f32(N, TD, like=x), _f32(TD, like=x),
            _f32(D, like=x), _f32(D, like=x))
    _launch("token_bwd", "mixer_token_bwd_bf16", x, (x, dh, *weights, ws, *outs),
            (B, N, D, TD, sms))
    return outs


def _chan_args(h, g, ln2w, ln2b, bc1, wc1, wc2):
    """Check the channel kernels' inputs; return (B, N, D, CD)."""
    if h.dim() != 3:
        raise ValueError(f"h must be (B, N, D), got shape {tuple(h.shape)}")
    B, N, D = h.shape
    CD = wc1.shape[0]
    _check_like(h, g, "g")
    check_weights(h, (ln2w, ln2b, bc1, wc1, wc2), ["ln2w", "ln2b", "bc1", "wc1", "wc2"],
                  [(D,), (D,), (CD,), (CD, D), (D, CD)])
    return B, N, D, CD


def chan_data_bwd(h, g, ln2w, ln2b, bc1, wc1, wc2):
    """Channel-mix data backward: (dh, dln2w, dln2b). CPU: the twin. CUDA:
    the kernel (bf16, contiguous)."""
    dev = _device(h, "channel-backward")
    B, N, D, CD = _chan_args(h, g, ln2w, ln2b, bc1, wc1, wc2)
    if dev == "cpu":
        return chan_data_bwd_ref(h, g, ln2w, ln2b, bc1, wc1, wc2)
    require_bf16_contiguous((h, g, ln2w, ln2b, bc1, wc1, wc2))
    ws = _workspace("mixer_chan_data_bwd_workspace", h, B, N, D, CD)
    outs = (torch.empty_like(h), _f32(D, like=h), _f32(D, like=h))
    _launch("chan_data_bwd", "mixer_chan_data_bwd_bf16", h,
            (h, g, ln2w, ln2b, bc1, wc1, wc2, ws, *outs), (B, N, D, CD))
    return outs


def chan_wgt_bwd(h, g, ln2w, ln2b, bc1, wc1, wc2):
    """Channel-mix weight backward: (dwc1, dwc2, dbc1). CPU: the twin.
    CUDA: the kernel (bf16, contiguous)."""
    dev = _device(h, "channel-backward")
    B, N, D, CD = _chan_args(h, g, ln2w, ln2b, bc1, wc1, wc2)
    if dev == "cpu":
        return chan_wgt_bwd_ref(h, g, ln2w, ln2b, bc1, wc1, wc2)
    require_bf16_contiguous((h, g, ln2w, ln2b, bc1, wc1, wc2))
    sms = _sms(h.device.index)
    ws = _workspace("mixer_chan_wgt_bwd_workspace", h, B, N, D, CD, sms)
    outs = (_f32(CD, D, like=h), _f32(D, CD, like=h), _f32(CD, like=h))
    _launch("chan_wgt_bwd", "mixer_chan_wgt_bwd_bf16", h,
            (h, g, ln2w, ln2b, bc1, wc1, wc2, ws, *outs), (B, N, D, CD, sms))
    return outs


class MixerBlockTrain(torch.autograd.Function):
    """The kernel route: ``fwd_with_h`` forward, the three backward kernels."""

    @staticmethod
    def forward(ctx, x, *weights):
        out, h = fwd_with_h(x, *weights)
        ctx.save_for_backward(x, h, *weights)
        return out

    @staticmethod
    def backward(ctx, g):
        x, h, *weights = ctx.saved_tensors
        ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2 = weights
        g = g.contiguous()
        dh, dln2w, dln2b = chan_data_bwd(h, g, ln2w, ln2b, bc1, wc1, wc2)
        dwc1, dwc2, dbc1 = chan_wgt_bwd(h, g, ln2w, ln2b, bc1, wc1, wc2)
        dbc2 = g.float().sum((0, 1))
        dx, dwt1, dwt2, dbt1, dln1w, dln1b = token_bwd(x, dh, ln1w, ln1b, wt1, bt1, wt2)
        dbt2 = dh.float().sum((0, 2))
        grads = (dx, dln1w, dln1b, dwt1, dbt1, dwt2, dbt2, dln2w, dln2b, dwc1, dbc1, dwc2, dbc2)
        return tuple(d.to(p.dtype) for d, p in zip(grads, (x, *weights)))


def fused_mixer_block_train(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2):
    """Differentiable Mixer block with the kernel backward (the JAX
    ``fused_mixer_block_train`` without its ``bt``)."""
    return MixerBlockTrain.apply(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1,
                                 wc2, bc2)
