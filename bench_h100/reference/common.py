"""What the plain references of every configuration share: the weight draw,
the preprocess, float32 with TF32 off, the dense product, a plain AdamW and
the three-step training reference.

Plain PyTorch only. Nothing here imports the port, ``jax`` or the JAX
package: the references are the yardstick the port is held to.
"""

from __future__ import annotations

import contextlib
import math

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def float32_exact():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def draw_weights(specs, seed, device, dtype=torch.float32):
    """{name: tensor} from ``specs`` [(name, shape, mean, std)]: one normal
    draw for all of them from a generator on ``device`` seeded with
    ``seed``, each leaf ``mean + std * z`` of its own slice, in ``dtype``."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, mean, std), n in zip(specs, sizes):
        out[name] = (z[at:at + n].view(shape) * std + mean).to(dtype)
        at += n
    return out


def preprocess(images_u8):
    """uint8 NHWC images → float32 NCHW, /255 and the ImageNet normalize
    (what a served image goes through before the model)."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def matmul(a, b):
    """The references' dense product: ``a @ b`` as it is."""
    return torch.matmul(a, b)


def gelu(x):
    """The exact GELU (torch ``nn.GELU()``), as the published models use."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def patch_embed(x, w, b, patch, mm=matmul):
    """Conv2d(k = s = patch) of NCHW ``x`` as patches times the flattened
    weight: (B, tokens, D), tokens in row-major order."""
    B, C, H, W = x.shape
    p = x.reshape(B, C, H // patch, patch, W // patch, patch).permute(0, 2, 4, 1, 3, 5)
    p = p.reshape(B, (H // patch) * (W // patch), C * patch * patch)
    return mm(p, w.reshape(w.shape[0], -1).t()) + b


def cross_entropy(logits, labels):
    return -torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0].mean()


class AdamW:
    """Plain AdamW (decoupled weight decay, bias-corrected moments), as
    Loshchilov and Hutter state it and ``torch.optim.AdamW`` computes it.
    A leaf without a gradient is left alone."""

    def __init__(self, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m / (1 - b1 ** self.t)
            vhat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


def train_reference(forward, weights, batches, optimizer, mm=matmul, rows=None):
    """Three (or len(batches)) plain float32 steps of ``forward`` from
    ``weights`` (copied, the caller's left alone) under ``optimizer``.

    Returns (losses, first gradient's norm per leaf, the parameters' change
    per leaf after the steps as its norm). ``rows``: fault planting for the
    control runs, the rows of each batch the loss is taken over (all by
    default)."""
    params = {k: v.detach().float().clone() for k, v in weights.items()}
    start = {k: v.clone() for k, v in params.items()}
    losses, grad1 = [], None
    with float32_exact():
        for i, batch in enumerate(batches):
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            x, y = batch["image"].float(), batch["label"]
            if rows is not None:
                x, y = x[rows], y[rows]
            loss = cross_entropy(forward(leaves, x, mm=mm), y)
            names = list(leaves)
            gs = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
            grads = {k: g for k, g in zip(names, gs) if g is not None}
            for v in params.values():
                v.requires_grad_(False)
            if i == 0:
                grad1 = {k: float(g.norm()) for k, g in grads.items()}
            optimizer.step(params, grads)
            losses.append(float(loss.detach()))
            del loss, gs, grads
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return losses, grad1, change


def _fake_quant(x, dtype):
    """``x`` rounded to an 8-bit float ``dtype`` under one scale for the
    whole tensor that maps its largest magnitude to the format's largest."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Forward through e4m3, the gradient through e5m2 (the usual fp8
    training recipe), each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fake_quant(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fake_quant(g, torch.float8_e5m2)


def matmul_fp8(a, b):
    """The control's dense product: both operands rounded to fp8 (e4m3,
    per-tensor scale), the products summed in float32; in a backward the
    incoming gradient rounded to e5m2."""
    return torch.matmul(_Fp8.apply(a), _Fp8.apply(b))


def leaf_gaps(prog, ref, keep=None):
    """The worst leaf's gap between two per-leaf norms: |prog − ref| over
    the larger of the leaf's reference norm and the median leaf's. A leaf
    missing on the program's side reads as norm 0. ``keep``: the leaves
    compared (all of ``ref`` by default)."""
    names = [k for k in ref if keep is None or k in keep]
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in names)
