"""Mixer block forward: the hand-written CUDA kernel, its plain twin, the wrapper.

Replaces ``jittor_mlp_tpu/ops/pallas/mixer_block.py::fused_mixer_block``. The
kernel source is ``csrc/mixer_block.cu`` (its header says what bounds it on
an H100 and what the design does about that). For x (B, N, D) the block is

    xn  = bf16(LN1(x))                          f32 stats and affine
    t   = bf16(gelu_tanh(Wt1 · xn + bt1))       per image, f32 accumulation
    h   = bf16(x + Wt2 · t + bt2)
    c   = bf16(gelu_tanh(bf16(LN2(h)) · Wc1ᵀ + bc1))
    out = bf16(h + c · Wc2ᵀ + bc2)

with the weights in their torch layouts: wt1 (TD, N), wt2 (N, TD),
wc1 (CD, D), wc2 (D, CD).

- ``mixer_block_ref``: plain PyTorch with the same rounding points (bf16
  operands upcast to f32, f32 matmuls, casts where the kernel casts). For
  float32 inputs it uses the exact-erf GELU, as the TPU kernel does.
- ``fused_mixer_block``: a CPU tensor goes to ``mixer_block_ref``; a CUDA
  bf16 contiguous tensor launches the kernel; anything else raises.
- ``LAUNCHES``: how many times the wrapper launched the kernel; ``routes()``:
  its channel products on each GEMM core (the wgmma core where TMA can load
  the operands, else the WMMA core).

Training (the recompute route; ``mixer_block_bwd`` holds the kernel route):

- ``mixer_block_plain``: a literal port of the JAX ``_plain_block``, which
  rounds to the input dtype after every product and bias add, as bf16
  XLA products do. It is the function whose autograd is the backward, and
  not the kernel twin.
- ``fused_mixer_block_trainable``: forward ``fused_mixer_block``, backward
  autograd of ``mixer_block_plain`` (``KernelForwardPlainBackward``), as the
  JAX custom VJP ``fused_mixer_block_trainable``.
"""

from __future__ import annotations

import threading

import torch

from ...core.nnf import gelu_erf, gelu_tanh
from ._build import Library

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_LIB = Library("mixer_block", ["mixer_block.cu"], {"mixer_block_bf16": (18, 5)},
               error="mixer_error_string", routes="mixer_gemm_products")


def layer_norm_f32(x, w, b, eps=1e-5):
    """LayerNorm with f32 stats and f32 affine, returned in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def mixer_block_ref(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                    wc1, bc1, wc2, bc2, with_h=False):
    """Plain PyTorch twin of the kernel, rounding where the kernel rounds;
    with ``with_h`` it returns (out, h), h the channel mix's input. On CUDA
    the float32 matmuls need TF32 off (PyTorch's default for matmuls) to
    match."""
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    xn = layer_norm_f32(x, ln1w, ln1b).to(dt)
    t = torch.matmul(wt1.float(), xn.float()) + bt1.float()[:, None]
    t = act(t).to(dt)
    h = x.float() + torch.matmul(wt2.float(), t.float()) + bt2.float()[:, None]
    h = h.to(dt)
    hn = layer_norm_f32(h, ln2w, ln2b).to(dt)
    c = act(torch.matmul(hn.float(), wc1.float().t()) + bc1.float()).to(dt)
    c2 = torch.matmul(c.float(), wc2.float().t()) + bc2.float()
    out = (h.float() + c2).to(dt)
    return (out, h) if with_h else out


def mixer_block_plain(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                      wc1, bc1, wc2, bc2):
    """The JAX ``_plain_block``: f32 LayerNorm statistics and affine cast
    to the input dtype, products and bias adds in the input dtype, the
    activation in f32 cast back."""
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh

    def ln(v, w, b):
        return layer_norm_f32(v, w, b).to(dt)

    y = torch.matmul(wt1, ln(x, ln1w, ln1b)) + bt1[:, None]
    y = act(y.float()).to(dt)
    h = x + torch.matmul(wt2, y) + bt2[:, None]
    c = torch.matmul(ln(h, ln2w, ln2b), wc1.t()) + bc1
    c = act(c.float()).to(dt)
    return h + torch.matmul(c, wc2.t()) + bc2


class KernelForwardPlainBackward(torch.autograd.Function):
    """A block kernel in the forward, autograd of the plain block in the
    backward (the JAX package's custom VJPs around its Pallas forwards).

    ``apply(kernel, plain, x, *weights)``: the forward returns
    ``kernel(x, *weights)`` and saves the inputs; the backward runs
    ``plain`` on them again and returns its input gradients."""

    @staticmethod
    def forward(ctx, kernel, plain, x, *weights):
        ctx.plain = plain
        ctx.save_for_backward(x, *weights)
        return kernel(x, *weights)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*inputs)
        return (None, None, *torch.autograd.grad(out, inputs, g))


def build():
    """Compile (if needed) and load the kernel library."""
    _LIB.load()


def routes():
    """{"sm90": n, "wmma": n}: the kernel's channel products so far on each
    GEMM core (csrc/gemm_sm90.cuh), two a launch."""
    return _LIB.routes()


def require_bf16_contiguous(tensors):
    """Raise unless every tensor is bf16 and contiguous (what the CUDA
    kernels take)."""
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")


def check_weights(x, weights, names, shapes):
    """Raise ValueError unless each weight has its shape and lies on x's
    device."""
    for name, w, shape in zip(names, weights, shapes):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(w.shape)} != {shape}")
        if w.device != x.device:
            raise ValueError(f"{name} is on {w.device}, x on {x.device}")


def block_dims(x, weights):
    """Check the block's 12 weights against x (B, N, D) in shape and device;
    return (B, N, D, TD, CD)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got shape {tuple(x.shape)}")
    B, N, D = x.shape
    TD = weights[2].shape[0]
    CD = weights[8].shape[0]
    want = [(D,), (D,), (TD, N), (TD,), (N, TD), (N,), (D,), (D,),
            (CD, D), (CD,), (D, CD), (D,)]
    names = ["ln1w", "ln1b", "wt1", "bt1", "wt2", "bt2", "ln2w", "ln2b",
             "wc1", "bc1", "wc2", "bc2"]
    check_weights(x, weights, names, want)
    return B, N, D, TD, CD


def fused_mixer_block(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                      wc1, bc1, wc2, bc2):
    """One Mixer block. CPU: the plain twin. CUDA: the kernel (bf16,
    contiguous), launched on the current stream; it raises on anything it
    does not take and never falls back to the twin."""
    global LAUNCHES
    weights = (ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2)
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    B, N, D, TD, CD = block_dims(x, weights)
    if x.device.type == "cpu":
        return mixer_block_ref(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"no mixer-block kernel for device {x.device}")
    require_bf16_contiguous((x, *weights))
    xn = torch.empty_like(x)
    t = torch.empty((B, TD, D), dtype=x.dtype, device=x.device)
    h = torch.empty_like(x)
    c = torch.empty((B * N, CD), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _LIB.launch("mixer_block_bf16", x.device, (x, *weights, xn, t, h, c, out),
                (B, N, D, TD, CD))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def fused_mixer_block_trainable(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b,
                                wc1, bc1, wc2, bc2):
    """Differentiable Mixer block: ``fused_mixer_block`` forward (the
    kernel on the card), autograd of ``mixer_block_plain`` backward."""
    return KernelForwardPlainBackward.apply(
        fused_mixer_block, mixer_block_plain, x, ln1w, ln1b, wt1, bt1, wt2, bt2,
        ln2w, ln2b, wc1, bc1, wc2, bc2)
