"""Kernel lab on the card: time Mixer-block variants over the 12-block Mixer-B/16 stack.

    python -m jittor_mlp_tpu_torch.tools.kernel_lab [--batch 256] [--iters 10] [--variants ...]

The port of ``tools/kernel_lab.py``. It checks the lab's kernels against
kernel 1 (``fused_mixer_block``) at batch 8, then times ``iters`` passes of
the stack (DEPTH blocks, one weight copy each) for each variant with CUDA
events, after one warm-up pass, and prints img/s and the stack's TFLOP/s
beside the card's name and power limit. It needs a CUDA card and raises
without one.

Variants (``VARIANTS``, the JAX tool's table; kernels in
``ops/kernels/kernel_lab.py``):

- ``prod2``, ``prod4``: kernel 1. Its CUDA kernel has no batch tile, so
  on the card they are one launch: ``prod4`` is timed once, as ``prod2``,
  and reported under both names (``SAME_AS``).
- ``wide2``, ``wide4``: ``wide_block`` at bt 2, 4.
- ``tokmajor2/4/8``: ``tokmajor_block``; the stack is relaid to token-major
  once before its blocks and once after (plain PyTorch copies), inside the
  timed pass.
- ``noscratch2``, ``noscratch4``: ``noscratch_block``; bt does not change
  its kernel, so ``noscratch4`` is reported as ``noscratch2``, like
  ``prod4``.
- ``relu_skel``, ``noln_skel``, ``matmul_skel``, ``gelu_fast3``,
  ``gelu_tanh``: ``ablate_block`` with (relu, LN), (exact, no LN), (relu,
  no LN), (fast3, LN), (tanh, LN).
- ``plain``: plain PyTorch, not a kernel: exact GELU, rounding to the input
  dtype after every product and bias add (the JAX tool's ``plain_xla``).

The JAX tool subtracted a 1-iteration run from each timing to take out the
TPU's dispatch overhead; CUDA events around the passes need no such
correction, so there is none here.

The functions read their shapes from their inputs, so they also run small
on the CPU (the tests); ``main`` runs only on the card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
import torch.nn.functional as F

from jittor_mlp_tpu_torch.ops.kernels import kernel_lab as kl
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as mb

N, D, TD, CD = 196, 768, 384, 3072
DEPTH = 12
CHECK_TOL = 1e-2  # max|Δ| from kernel 1, absolute (the JAX tool's bound); see check()
DEFAULT_VARIANTS = "prod2,prod4,wide2,wide4,noscratch2,noscratch4"
# name → (the wrapper it runs, its keyword arguments), in the JAX tool's
# order; the wrappers are ops/kernels/kernel_lab.py's and kernel 1's
# fused_mixer_block; plain runs none
VARIANTS = {
    "prod2": ("fused_mixer_block", {}),
    "prod4": ("fused_mixer_block", {}),
    "wide2": ("wide_block", {"bt": 2}),
    "wide4": ("wide_block", {"bt": 4}),
    "tokmajor2": ("tokmajor_block", {"bt": 2}),
    "tokmajor4": ("tokmajor_block", {"bt": 4}),
    "tokmajor8": ("tokmajor_block", {"bt": 8}),
    "noscratch2": ("noscratch_block", {"bt": 2}),
    "noscratch4": ("noscratch_block", {"bt": 4}),
    "relu_skel": ("ablate_block", {"bt": 2, "gelu": "relu", "ln": True}),
    "noln_skel": ("ablate_block", {"bt": 2, "gelu": "exact", "ln": False}),
    "matmul_skel": ("ablate_block", {"bt": 2, "gelu": "relu", "ln": False}),
    "gelu_fast3": ("ablate_block", {"bt": 2, "gelu": "fast3", "ln": True}),
    "gelu_tanh": ("ablate_block", {"bt": 2, "gelu": "tanh", "ln": True}),
    "plain": (None, {}),
}
# variants that launch the same kernel on the same arguments as an earlier
# one on the card: timed once, reported under both names
SAME_AS = {"prod4": "prod2", "noscratch4": "noscratch2"}


def make_weights(seed, device, n=N, d=D, td=TD, cd=CD):
    """The block's 12 weights in torch layouts, 0.02·N(0, 1) in bf16, drawn
    on the CPU from an explicit generator (so every device gets the same)."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(d,), (d,), (td, n), (td,), (n, td), (n,), (d,), (d,), (cd, d), (cd,), (d, cd),
              (d,)]
    return tuple((torch.randn(s, generator=g) * 0.02).bfloat16().to(device) for s in shapes)


def make_input(seed, batch, device, n=N, d=D):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, n, d), generator=g).bfloat16().to(device)


def plain(w, h):
    """The block in plain PyTorch: exact GELU, products and bias adds in the
    input dtype (the JAX tool's ``plain``)."""
    ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2 = w
    dt = h.dtype

    def ln(v, g, b):
        return mb.layer_norm_f32(v, g, b).to(dt)

    def gelu(v):
        return F.gelu(v.float()).to(dt)

    y = gelu(torch.matmul(wt1, ln(h, ln1w, ln1b)) + bt1[:, None])
    h = h + torch.matmul(wt2, y) + bt2[:, None]
    c = gelu(torch.matmul(ln(h, ln2w, ln2b), wc1.t()) + bc1)
    return h + torch.matmul(c, wc2.t()) + bc2


def _block(wrapper, kw):
    return lambda w, h: wrapper(h, *w, **kw)


def variants():
    """name → (block(w, h), pre, post) for each of VARIANTS: pre and post
    relay the activation once around the stack (token-major variants), else
    None."""
    out = {}
    for name, (fn, kw) in VARIANTS.items():
        if fn is None:
            out[name] = (plain, None, None)
            continue
        block = _block(getattr(mb if fn == "fused_mixer_block" else kl, fn), kw)
        if fn == "tokmajor_block":
            out[name] = (block, lambda x, bt=kw["bt"]: kl.to_tokmajor(x, bt), kl.from_tokmajor)
        else:
            out[name] = (block, None, None)
    return out


def bf16_ulp(v):
    """One bf16 ulp at each |v| (float32 v): 2^(e - 8) for |v| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


def check(weights, x):
    """wide, noscratch and tokmajor at bt 2 against kernel 1 on x; returns
    name → max|Δ| and raises if one is out of its bound.

    The bound is the JAX tool's, max|Δ| < CHECK_TOL absolute, for wide and
    noscratch. tokmajor's LN2 reads the f32 h where kernel 1 reads the bf16
    h, which moves some bf16 outputs by one ulp: 1.5625e-2 where |out| is in
    [2, 4). So each tokmajor output may differ from kernel 1's by CHECK_TOL
    or by one bf16 ulp of kernel 1's output, whichever is larger."""
    want = mb.fused_mixer_block(x, *weights).float()
    room = torch.clamp_min(bf16_ulp(want), CHECK_TOL)  # tokmajor's, per output
    runs = {
        "wide": lambda: kl.wide_block(x, *weights, bt=2),
        "noscratch": lambda: kl.noscratch_block(x, *weights, bt=2),
        "tokmajor": lambda: kl.from_tokmajor(kl.tokmajor_block(kl.to_tokmajor(x, 2), *weights,
                                                               bt=2)),
    }
    errs = {}
    for name, run in runs.items():
        diff = (run().float() - want).abs()
        errs[name] = diff.max().item()
        if name == "tokmajor":
            worst = (diff / room).max().item()
            ok = worst <= 1
            limit = f"max({CHECK_TOL}, one bf16 ulp of |prod|) each; worst |Δ|/limit {worst:.4g}"
        else:
            ok = errs[name] < CHECK_TOL
            limit = f"< {CHECK_TOL}"
        print(f"check {name:10s} max|Δ| vs prod = {errs[name]:.6g} (limit {limit})", flush=True)
        if not ok:
            raise RuntimeError(f"kernel lab check: {name} is {errs[name]} from kernel 1")
    return errs


def stack_gflop(n=N, d=D, td=TD, cd=CD, depth=DEPTH):
    """GFLOP of one image through the stack."""
    return 2 * n * d * (2 * td + 2 * cd) * depth / 1e9


def _elapsed_ms(fn, device):
    """Milliseconds of fn(): CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def bench_stack(name, block, stacked, x, iters, pre=None, post=None, label=""):
    """Run one warm-up pass and ``iters`` timed passes of the stack on x: pre,
    one block per weight tuple of ``stacked``, post. The timed passes are
    timed together. Prints and returns (output of the last pass, stats)."""
    out = None

    def passes(k):
        nonlocal out
        for _ in range(k):
            h = pre(x) if pre is not None else x
            for w in stacked:
                h = block(w, h)
            out = post(h) if post is not None else h

    passes(1)
    ms = _elapsed_ms(lambda: passes(iters), x.device) / iters
    B, n, d = x.shape
    td, cd = stacked[0][2].shape[0], stacked[0][8].shape[0]
    img_s = B * 1e3 / ms
    tflops = img_s * stack_gflop(n, d, td, cd, len(stacked)) / 1e3
    print(f"{name:14s} {img_s:10.1f} img/s {tflops:8.2f} TFLOP/s (stack only; {ms:.4f} ms a "
          f"pass; b{B}, 1+{iters} passes; {label or x.device})", flush=True)
    return out, {"img_s": img_s, "tflops": tflops, "ms": ms, "passes": 1 + iters}


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def bench(names, weights, batch, iters, label=""):
    """bench_stack for each variant in ``names`` on a seeded (batch, N, D)
    input, the stack DEPTH copies of ``weights``; a variant of SAME_AS whose
    twin ran already takes its twin's stats, with "same_as" naming it.
    Returns name → stats."""
    stacked = [tuple(t.clone() for t in weights) for _ in range(DEPTH)]
    n, d = weights[2].shape[1], weights[0].shape[0]
    x = make_input(2, batch, weights[0].device, n, d)
    table = variants()
    stats = {}
    for name in names:
        if SAME_AS.get(name) in stats:
            stats[name] = dict(stats[SAME_AS[name]], same_as=SAME_AS[name])
            print(f"{name:14s} = {SAME_AS[name]} (the same kernel launch on the card; timed once)",
                  flush=True)
            continue
        block, pre, post = table[name]
        out, stats[name] = bench_stack(name, block, stacked, x, iters, pre, post, label=label)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: non-finite output")
    return stats


def run(names, batch, iters, label):
    """The lab on the card: build, check, then bench. Returns name → stats."""
    kl.build()
    mb.build()
    weights = make_weights(0, "cuda")
    check(weights, make_input(1, 8, "cuda"))
    return bench(names, weights, batch, iters, label)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help=f"comma-separated, of: {', '.join(variants())}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_lab: no CUDA card (the lab times kernels on the card only)")
    names = args.variants.split(",")
    unknown = [n for n in names if n not in variants()]
    if unknown:
        raise SystemExit(f"kernel_lab: unknown variants {unknown}")
    label = card()
    print(f"card: {label}", flush=True)
    run(names, args.batch, args.iters, label)


if __name__ == "__main__":
    main()
