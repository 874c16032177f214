#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

Builds the port's CUDA kernels from this checkout (one nvcc per source,
all at once), checks each against its plain PyTorch twin, drives the
port's serving paths through ``Predictor`` and ``MicroBatcher``, times
kernels against plain versions, and trains: bf16 mixed-precision train
steps through ``make_train_step`` on both Mixer routes (the forward kernel
with the plain block's backward, and under ``config.pallas_bwd`` the
backward kernels), ResMLP-S24 and gMLP-S steps, and AS-MLP-T steps with
drop-path; then runs the port's kernel lab over the Mixer-B/16 stack, and
serves the ten families that have no kernel of their own. Models: Mixer-B/16 @224 (d_model 768, depth 12, token_dim 384; bench.py's
config), ResMLP-S24 @224 (d_model 384, depth 24, expansion 4;
compare.py's), gMLP-S @224 (d_model 256, d_ffn 1536, depth 30;
compare.py's) and AS-MLP-T @224 (embed 96, depths [2, 2, 6, 2], shift 5:
the factory's defaults, compare.py's), full width and depth, random
weights from seed 0; and in phase 8, at the widths of compare.py's CONFIGS
and full depth: ViP (patch 14, d_model 256, depth 30, segments 16,
weighted), S2-MLP-wide (S2MLPv1_wide), S2-MLPv2 (patches [7, 2], d_model
[192, 384], depths [4, 14]), RaftMLP (two levels of dims 64 and 128),
Swin-MLP-T, DynaMixer-T, MS-MLP-T (embed 96, depths [2, 2, 6, 2], shift
5), Hire-MLP-Tiny (the factory's defaults), CycleMLP-B2 and ActiveMLP-xT
(depths [2, 2, 4, 2], share [2, 4, 4, 8], intv 2). Run from the repository
root, with no arguments:

    python3 chip_smoke.py

Phases (each one fails loudly; there is no CPU fallback):
  1. the card, the kernels' build time, and the tile, ring stages and
     shared memory of the channel products' GEMM core (gemm_sm90.cuh);
  2. every kernel vs its twin at the full block shape (B=8), two ragged
     small shapes and, for the W8A8 Mixer and ResMLP kernels and the
     Mixer training kernels, a chunked shape (CD ≥ 2048, ragged chunk and
     tokens), every output within 1.6e-2 of max(1, max|ref|); two calls on
     the same inputs agree bit for bit. The training kernels and the W8A8
     gMLP and ResMLP blocks also run at the train step's b128 and at b131;
     there each weight gradient's sum over images has partials of several
     images and a short last one (printed, and checked to occur), and the
     token and channel weight backwards' twins sum in the kernel's groups
     and slabs. The axial shift, a copy, equals its twin bit
     for bit at every AS-MLP-T stage shape (B=8) and five ragged shapes,
     both axes, both signs, bf16 and float32, and its autograd wrapper's
     backward on a non-contiguous gradient equals the twin at sign -1.
     The GEMM core alone (gemm_tn, both epilogues): Mixer-B/16's two
     channel products at B=8 and three ragged (M, N, K), each counted on the
     wgmma core, the first two also on the WMMA core, and a K % 8 != 0 shape
     counted on the WMMA route (the wgmma core refuses it), within the same
     band, two calls bit-equal. Its other modes alone: gemm_bf16 (MN-major
     A and/or B, row slabs with one f32 partial each) at Mixer-B/16's four
     channel backward products at B=8 and ragged ones (a short last slab),
     on the wgmma core and the WMMA core, and rows 72 bytes apart on the
     WMMA route; gemm_bf16 with batch entries at the bf16 gMLP block's
     three products at B=8 and b256 (Wsp shared in rows of 200, vn an
     N-major entry an image) and a ragged token product, on both cores;
     gemm_s8 (int8 with row and column scales, entries batched or shared)
     at gMLP-S's three products and the W8A8 Mixer-B/16 block's four at B=8
     and b256 and ragged ones, the Mixer's second channel product in the
     chunked mode (4 chunks of 768 codes; and 4 of 544, ending inside a
     128-code K step; one chunk; batched 32-code chunks), on the s8 wgmma
     core and mma.sync, bit-equal to its twin; the dual mode
     (gemm_bf16_dual: two products of one tile, both stored) at Mixer-B/16's
     two pairs (the channel data backward's and the token backward's) at
     B=8 and b256 and ragged shapes, an MN-major A among them, on both
     cores, and rows 72 bytes apart on the WMMA route; the Group mode
     (gemm_bf16_group: a sum over images, a group of images in each tile's
     K loop) at the token backward's dWt2 and dWt1 at B=8, b128 and b131 in
     its groups (partials of several images and a short last one, printed
     and checked to occur), a ragged one, the b131 dWt2 on the WMMA core's
     gemm_sum and rows 72 bytes apart on the WMMA route. Kernel 1 and the
     four training kernels also run at D=36, the bf16 gMLP
     and ResMLP blocks at D=36 and at D=44, F=100, where their bf16
     products (some or all) take the WMMA route; at every shape the route
     counts of those kernels and of the W8A8 gMLP, Mixer and ResMLP blocks
     (three, four and three s8 wgmma products a call) are checked; the
     ResMLP blocks' three products alone (gemm_bf16 with Wt shared in rows
     of 200 and h an N-major entry an image; gemm_s8) at B=8 and b256 on
     both cores of each type;
  3. logits on 64 random images: Mixer-B/16 bf16 kernel path vs the plain
     bf16 path and the float32 forward (TF32 off); Mixer-B/16 int8 vs the
     bf16 kernel path and f32; ResMLP-S24 (γ = 0.1, perturbed affines)
     bf16 kernel path vs plain bf16 and f32, int8 vs f32; gMLP-S the same,
     and its blocks must move the logits (vs channel_proj2 zeroed) by at
     least 10x the kernel path's deviation from f32; AS-MLP-T bf16 kernel
     path vs plain bf16 and f32, int8 vs f32, and its shift must move the
     logits (vs shift_size 1, the identity shift) by at least 10x the
     kernel path's deviation from f32. Bands: bf16 5e-2 of
     max|logit| and 90% top-1, int8 0.1 and 90%. Launches rise by depth
     per forward (by 24, two shifts a block, for AS-MLP-T); a Mixer-B/16
     bf16 forward runs 2 x depth channel products on the wgmma core and
     none on the WMMA core, a Mixer-B/16 int8 forward 4 x depth products on
     the s8 wgmma core and none on mma.sync, a gMLP-S or ResMLP-S24 bf16
     forward 3 x depth on the wgmma core and none on WMMA, and a gMLP-S or
     ResMLP-S24 int8 forward 3 x depth on the s8 wgmma core and none on
     mma.sync (so do the serving runs of phase 4, each block library's
     products checked at every run);
  4. serving: (a) Mixer-B/16 bf16 Predictor(batch_size=32) behind
     MicroBatcher, 64 requests from 8 threads plus 2 resized ones;
     (b) Mixer-B/16 compute="int8" and bf16 Predictors on one model, and
     (c) ResMLP-S24 and (e) gMLP-S int8 and bf16 Predictors on one model,
     each pair served at the same time from 8 threads, so that an int8
     flag shared between threads would show; every batched answer equals
     predict() alone; launches equal depth × forwards per kernel;
     (d) ResMLP-S24 and (f) gMLP-S weights="int8" Predictors agree with
     the bf16 ones; (g) AS-MLP-T int8 and bf16 Predictors on one model
     served at once, shift launches 24 × the forwards of both, and (h) its
     weights="int8" Predictor agrees with the bf16 one;
  5. CUDA-event timings at b256: each kernel vs its twin (the shift at
     AS-MLP-T's stage-1 shape, both axes; the W8A8 gMLP block beside the
     bytes of its f32 intermediates, the W8A8 Mixer, bf16 gMLP and both
     ResMLP blocks beside the bytes of their data flows); the GEMM core at
     the two channel products, on each core and against cuBLAS's
     torch.matmul; its other modes at gMLP-S's and ResMLP-S24's three int8
     products and the W8A8 Mixer block's four (against mma.sync and
     torch._int_mm), gMLP-S's and ResMLP-S24's three bf16 products and
     Mixer-B/16's four channel backward products (against WMMA and
     torch.matmul); the dual mode at the two backward pairs (against WMMA and
     two torch.matmul calls) and the Group mode at dWt2 and dWt1 (against
     WMMA's gemm_sum and torch.einsum); rows 6 and 7's data-flow floors
     before and after their redesign; the forwards
     kernel vs plain (Mixer-B/16, gMLP-S and AS-MLP-T bf16) and int8 vs
     bf16 (all four models);
  6. training, bf16 with f32 master weights: (a) all 13 gradients of one
     full-shape Mixer block (B=8), kernel route vs autograd of the kernel
     twin and vs the recompute route, per tensor; (b) Mixer-B/16 at b32:
     every parameter's gradient on the kernel route, the recompute route
     and the plain bf16 path against float32 (TF32 off), as one global
     relative L2 error, ≤ 1.7e-2, and ≤ 1.1e-2 between the two kernel
     routes and ≤ 1.5e-2 between either and the plain path (3x the values
     read on an H100);
     (c) 10 AdamW steps at b128 on one batch, each route with remat off
     and on: the loss descends, and remat gives the same losses; (d) the
     launches per step, depth × (1, or 2 for a forward kernel under
     remat), and the products of the block forward and the three backwards
     (2, 5, 3 and 4 a block: 14), all on the wgmma core, with a dual launch
     a token or channel data backward and two Group launches a token
     backward; (e) one
     ResMLP-S24 (γ = 0.1) and one gMLP-S step, gradients against their
     plain bf16 paths (≤ 3e-2, as (a)), each forward's 3 x depth products
     on the wgmma core; (f) Mixer-B/16 train img/s at b128 on each route
     and the plain path, and gMLP-S's and ResMLP-S24's on their kernel and
     plain paths, in turns, with peak memory; AS-MLP-T: (g) b32 gradients of the kernel
     path against the plain bf16 path (≤ 3e-2) and both against float32
     (global relative L2), 48 shift launches a step; (h) 10 AdamW steps at
     b128 with drop_path_rate 0.1 and a seeded generator, remat off and on:
     the loss descends, remat gives the same losses, 480 (720 under remat)
     shift launches; (i) train img/s at b128, kernel path and plain path
     in turns, with peak memory;
  7. the kernel lab (``jittor_mlp_tpu_torch.tools.kernel_lab``, the port of
     tools/kernel_lab.py) through its own functions: its check of the wide,
     noscratch and tokmajor kernels against kernel 1 at b8, then every
     variant of its table over the 12-block Mixer-B/16 stack at b256 (img/s
     and TFLOP/s; prod4 and noscratch4 launch what prod2 and noscratch2 do
     and are reported as them); each lab kernel launches 12 times a pass of
     its own variants, warm-up included, and their channel products all run
     on the wgmma core. Phase 2 also holds the four lab
     kernels against their twins at every bt and mode the lab uses, at b8,
     the stack's b256 and two ragged shapes, and phase 5 times them at b256;
  8. the ten families without a kernel (plain PyTorch: cuBLAS products,
     cuDNN convolutions, gathers), each built by its factory on the card:
     float32 logits on the card (TF32 off) against the same state dict on
     the CPU at b2, within 1e-3 of
     max|logit|; bf16 against card f32 on 64 images within 5e-2 of
     max|logit| and 90% top-1, compute="int8" within 0.1 (its top-1
     agreement printed: near ties of random-init logits); the
     blocks (each residual branch's last layer zeroed: identity blocks)
     move the bf16 logits at least 10x the bf16 deviation from f32; bf16
     and weights="int8" Predictors answer 16 images batched as they answer
     each alone; b256 img/s in bf16 and int8 (CUDA events) and peak memory.
     No port kernel launches in this run. ViP's and S2-MLPv2's gates read
     the mean over their tokens (``mean_gate``), and MS-MLP-T's layer scale
     is 0.5 (``layer_scale``), as state-dict edits of the seed's draw.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 1.6e-2  # two bf16 ulps of the output scale
# Phase 6b, the global relative L2 error of Mixer-B/16's bf16 gradients:
# 3x the values read on an H100 (PERF.md, Findings): each bf16 path vs float32
# 5.2e-3 to 5.7e-3; the kernel route vs the recompute route 3.7e-3; either
# vs the plain bf16 path 5.1e-3.
GRAD_VS_F32 = 1.7e-2
GRAD_ROUTES = 1.1e-2  # kernel route vs recompute route
GRAD_PLAIN = 1.5e-2  # a kernel route vs the plain bf16 path
GRAD_BLOCK = 3e-2  # phases 6a and 6e: each tensor, or one model's, between two bf16 paths
MIXER_B16 = dict(d_model=768, depth=12, token_dim=384)
RESMLP_S24 = dict(d_model=384, depth=24, expansion_factor=4)
GMLP_S = dict(image_size=224, patch_size=16, d_model=256, d_ffn=1536, depth=30)
DEPTH = MIXER_B16["depth"]  # one kernel launch per block
RES_DEPTH = RESMLP_S24["depth"]
GMLP_DEPTH = GMLP_S["depth"]
AS_MLP_T = {}  # the AS_MLP factory's defaults: embed 96, depths [2, 2, 6, 2], shift 5
SHIFTS = 2 * (2 + 2 + 6 + 2)  # shift launches per AS-MLP-T forward: two per block
# Phase 6g: AS-MLP-T's bf16 gradients against float32, global relative L2:
# 3x the value read on an H100 (1.23e-2 on either bf16 path, PERF.md)
AS_GRAD_VS_F32 = 3.7e-2
# the shift's phase-2 shapes (B, H, W, C) and shift sizes: every AS-MLP-T
# stage at B=8, then ragged ones: C=10 at shift 3, four groups (C=16,
# shift 5), groups of 7, 7, 6 (C=20, shift 3), H ≠ W, C < shift
SHIFT_SHAPES = [((8, 56, 56, 96), 5), ((8, 28, 28, 192), 5), ((8, 14, 14, 384), 5),
                ((8, 7, 7, 768), 5), ((2, 6, 7, 10), 3), ((2, 5, 6, 16), 5), ((2, 6, 5, 20), 3),
                ((1, 4, 9, 12), 5), ((2, 5, 4, 3), 5)]
# H100 SXM data sheet: dense tensor-core peaks and HBM rate
PEAK = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_S = 3.35e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _draw(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    def lin(out, fan_in):  # weight (out, fan_in), bias (out,)
        return rn(out, fan_in, scale=fan_in ** -0.5), rn(out, scale=0.5)

    return rn, lin


def block_inputs(B, N, D, TD, CD, seed):
    """bf16 Mixer-block inputs on the card, from a seeded CUDA generator.

    Weights are scaled by 1/sqrt(fan_in) and biases drawn with std 0.5, so
    the outputs are O(1) and one misplaced bias element moves an output by
    far more than the tolerance band."""
    rn, lin = _draw(seed)

    def ln():  # LayerNorm weight, bias (D,)
        return rn(D, scale=0.1, mean=1.0), rn(D, scale=0.1)

    x = rn(B, N, D)
    w = (*ln(), *lin(TD, N), *lin(N, TD), *ln(), *lin(CD, D), *lin(D, CD))
    return x, w


def resmlp_inputs(B, N, D, F, seed):
    """bf16 ResMLP-block inputs on the card: weights as in block_inputs;
    affines α = 1 + 0.1·randn, β = 0.5·randn and gammas 1 + 0.1·randn, all
    O(1) (ResMLP-S24 starts γ at 1e-5, where a wrong block would move the
    output by almost nothing)."""
    rn, lin = _draw(seed)

    def aff():
        return rn(D, scale=0.1, mean=1.0), rn(D, scale=0.5)

    x = rn(B, N, D)
    a1, b1 = aff()
    g1 = rn(D, scale=0.1, mean=1.0)
    wt, bt = lin(N, N)
    a2, b2 = aff()
    g2 = rn(D, scale=0.1, mean=1.0)
    return x, (a1, b1, g1, wt, bt, a2, b2, g2, *lin(F, D), *lin(D, F))


def gmlp_inputs(B, N, D, F, seed):
    """bf16 gMLP-block inputs on the card: weights and biases as in
    block_inputs, LayerNorm affines near 1, the spatial bias with mean 1.0
    (the model's init value) and std 0.5."""
    rn, lin = _draw(seed)

    def ln(n):
        return rn(n, scale=0.1, mean=1.0), rn(n, scale=0.1)

    x = rn(B, N, D)
    ln1w, ln1b = ln(D)
    w1, b1 = lin(2 * F, D)
    sgu_w, sgu_b = ln(F)
    wsp = lin(N, N)[0]
    bs = rn(N, scale=0.5, mean=1.0)
    return x, (ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, *lin(D, F))


def train_inputs(kernel):
    """Inputs of a Mixer training kernel: block_inputs, and for the backward
    kernels an O(1) upstream gradient (dh for the token kernel, g for the
    channel kernels, where x stands in for h)."""

    def make(B, N, D, TD, CD, seed):
        x, w = block_inputs(B, N, D, TD, CD, seed)
        if kernel == "fwd_with_h":
            return x, w
        g = _draw(seed + 1)[0](B, N, D)
        ln1w, ln1b, wt1, bt1, wt2, _, ln2w, ln2b, wc1, bc1, wc2, _ = w
        if kernel == "token_bwd":
            return x, (g, ln1w, ln1b, wt1, bt1, wt2)
        return x, (g, ln2w, ln2b, bc1, wc1, wc2)

    return make


KERNEL_MODULES = ("mixer_block", "mixer_block_int8", "resmlp_block", "resmlp_block_int8",
                  "gmlp_block", "gmlp_block_int8", "mixer_block_bwd", "axial_shift", "kernel_lab",
                  "gemm_sm90")
PALLAS = "jittor_mlp_tpu/ops/pallas/"
SHIFT_REPLACES = PALLAS + "shift_kernel.py:50"
# The kernel lab's kernels: wrapper → (source, the TPU kernel it replaces).
# The variants (bt and mode) each runs are the lab's own table, lab_variants.
LAB_KERNELS = {
    "tokmajor_block": ("lab_tokmajor.cu", "tools/kernel_lab.py:124 (_call_tokmajor, body "
                       "_kernel_tokmajor :89)"),
    "wide_block": ("lab_wide.cu", "tools/kernel_lab.py:255 (_call, body _kernel_wide :39)"),
    "noscratch_block": ("lab_ablate.cu",
                        "tools/kernel_lab.py:255 (_call, body _kernel_noscratch :224)"),
    "ablate_block": ("lab_ablate.cu",
                     "tools/kernel_lab.py:255 (_call, bodies _make_kernel_ablate :166)"),
}
# the lab's check and stack shapes (b8, b256) and two ragged ones
LAB_SHAPES = [(8, 196, 768, 384, 3072), (8, 20, 36, 24, 72), (8, 33, 136, 50, 200),
              (256, 196, 768, 384, 3072)]
LAB_TIMED = "gelu_tanh"  # the ablate kernel's mode in its phase-5 row: all of the block's work
LAB_ITERS = 10  # timed stack passes per variant in phase 7, after one warm-up pass
TRAIN_KERNELS = {"fwd_with_h": "mixer_block_bwd.py:129", "token_bwd": "mixer_block_bwd.py:220",
                 "chan_data_bwd": "mixer_block_bwd.py:306", "chan_wgt_bwd": "mixer_block_bwd.py:397"}
# Beyond the shared shapes: chunked CD, the train step's b128, and b131, where
# the last f32 partial of each weight-gradient sum takes fewer images
# than the others (on an H100: dWt1/dWt2 in 33 partials of 4 images, the
# last of 3; dWc1/dWc2 in 2 slabs of 66 images, the last of 65).
TRAIN_SHAPES = [(2, 33, 136, 50, 2056), (128, 196, 768, 384, 3072), (131, 196, 768, 384, 3072)]
# argument of the weight that gives the inner width (TD, CD) of a
# weight-gradient kernel's grouped sums
GROUPED = {"token_bwd": 3, "chan_wgt_bwd": 4}
# kernels whose products run on gemm_sm90.cuh's core, and the routes of one
# call's products at (B, N, D, TD, CD) or (B, N, D, F): a bf16 product takes
# the wgmma core where TMA can load both operands (rows a multiple of 16
# bytes apart: D and CD, or D and F, multiples of 8), else the WMMA core;
# the W8A8 blocks' products take the s8 wgmma core (their operands are
# padded to 32 codes), none mma.sync.


def _bf16_routes(*on_sm90):
    return {"sm90": sum(on_sm90), "wmma": len(on_sm90) - sum(on_sm90)}


ROUTED = {
    # hn·Wc1ᵀ (rows D apart), c·Wc2ᵀ (rows CD apart)
    "fused_mixer_block": lambda s: _bf16_routes(s[2] % 8 == 0, s[4] % 8 == 0),
    "fwd_with_h": lambda s: _bf16_routes(s[2] % 8 == 0, s[4] % 8 == 0),
    # the dual product (two: hn·Wc1ᵀ, g·Wc2 with Wc2ᵀ copied; rows D apart),
    # then dhn = dcp·Wc1 (dcp rows CD apart)
    "chan_data_bwd": lambda s: _bf16_routes(s[2] % 8 == 0, s[2] % 8 == 0,
                                            s[2] % 8 == s[4] % 8 == 0),
    # the dual product an image (two), dWt2 and dWt1 in image groups, dxn:
    # xn, dh, t and dtp rows D apart, the weights copied into rows of Np
    "token_bwd": lambda s: _bf16_routes(*[s[2] % 8 == 0] * 5),
    # the two recompute products, then dcpᵀ·hn and gᵀ·c (rows CD and D apart)
    "chan_wgt_bwd": lambda s: _bf16_routes(s[2] % 8 == 0, *[s[2] % 8 == s[4] % 8 == 0] * 3),
    # xn·W1ᵀ (rows D apart), Wsp·vn (vn rows F apart), g·W2ᵀ (rows F apart)
    "fused_gmlp_block": lambda s: _bf16_routes(s[2] % 8 == 0, s[3] % 8 == 0, s[3] % 8 == 0),
    "fused_gmlp_block_int8": lambda s: {"sm90_s8": 3, "mma_s8": 0},
    # Wt·h per image (h rows D apart), h2b·W1ᵀ (rows D apart), c·W2ᵀ (rows F apart)
    "fused_resmlp_block": lambda s: _bf16_routes(s[2] % 8 == 0, s[2] % 8 == 0, s[3] % 8 == 0),
    # the token product, FF1, FF2 (chunked where F >= 2048 and F % 4 == 0)
    "fused_resmlp_block_int8": lambda s: {"sm90_s8": 3, "mma_s8": 0},
    # the two token products, the two channel products (the second chunked)
    "fused_mixer_block_int8": lambda s: {"sm90_s8": 4, "mma_s8": 0},
}
# products on the GEMM cores per block of each routed forward kernel at the
# models' widths (every operand one TMA can load), by library: (route,
# products a launch); and on the bf16 wgmma core per Mixer-B/16 block of a
# kernel-route step: the forward's two, the token backward's five (a dual
# product counts two), the channel data backward's three and the channel
# weight backward's four: 14
BLOCK_PRODUCTS = {"mixer_block": ("sm90", 2), "mixer_block_int8": ("sm90_s8", 4),
                  "gmlp_block": ("sm90", 3), "gmlp_block_int8": ("sm90_s8", 3),
                  "resmlp_block": ("sm90", 3), "resmlp_block_int8": ("sm90_s8", 3)}
BWD_PRODUCTS = {"fwd_with_h": 2, "token_bwd": 5, "chan_data_bwd": 3, "chan_wgt_bwd": 4}
# the wgmma core's dual and Group launches per launch of each backward kernel
BWD_MODES = {"token_bwd": {"dual": 1, "group": 2}, "chan_data_bwd": {"dual": 1, "group": 0}}
# the kernels line's rows of a block library's products on the core
PRODUCT_ROWS = {"mixer_block_int8": "gemm_s8_mixer_sm90", "gmlp_block": "gemm_bf16_gmlp_sm90",
                "gmlp_block_int8": "gemm_s8_sm90", "resmlp_block": "gemm_bf16_resmlp_sm90",
                "resmlp_block_int8": "gemm_s8_resmlp_sm90"}
# The GEMM core's phase-2 shapes (M, N, K): Mixer-B/16's two channel
# products at B = 8, then ragged M, N and K (one row; K = 40 and 136 end
# in a part of a 64-wide K step; N = 72 and 200 in a part of a 256-wide
# tile); each with the GELU and the residual epilogue, on the wgmma core.
GEMM_SHAPES = [(1568, 3072, 768), (1568, 768, 3072), (97, 72, 40), (165, 200, 136),
               (1, 3072, 768)]
GEMM_WMMA_SHAPE = (33, 40, 50)  # K % 8 != 0: rows 100 bytes apart, the WMMA route
GEMM_TIMED = [(256 * 196, 3072, 768), (256 * 196, 768, 3072)]  # b256's channel products
GEMM_REPLACES = PALLAS + "mixer_block.py:157 (the channel half of fused_mixer_block)"


def kernel_table(mods):
    """name → (module, wrapper, twin, inputs, shapes, source, replaced, depth)."""
    mixer_shapes = [(8, 196, 768, 384, 3072), (3, 20, 40, 24, 72), (5, 33, 136, 50, 200)]
    # kernel 1 and the training kernels also at D = 36, CD = 100: rows 72
    # and 200 bytes apart, which TMA cannot load, so their bf16 products
    # take the WMMA core (ROUTED)
    fwd_shapes = mixer_shapes + [(2, 33, 36, 50, 100)]
    res_shapes = [(8, 196, 384, 1536), (3, 20, 40, 72), (5, 33, 136, 200)]
    # the bf16 ResMLP block also at D = 36 (the token product's h and FF1's
    # rows 72 bytes apart: the WMMA route, FF2 on wgmma) and D = 44, F = 100
    # (all three on WMMA) (ROUTED)
    res_bf16_shapes = res_shapes + [(3, 20, 36, 72), (2, 13, 44, 100)]
    # the W8A8 ResMLP block: a chunked shape (F = 2056: four chunks of 514
    # codes padded to 544, each ending inside a 128-code K step), and, as its
    # token product is one launch over the images, the batches the path runs
    # it at: b128 and b131 (a short last entry)
    res_int8_shapes = res_shapes + [(2, 33, 136, 2056), (128, 196, 384, 1536),
                                    (131, 196, 384, 1536)]
    gmlp_shapes = [(8, 196, 256, 1536), (3, 20, 40, 72), (5, 33, 136, 200)]
    # the bf16 gMLP block also at D = 36 (GEMM1's rows 72 bytes apart: the
    # WMMA route, the other two on wgmma) and D = 44, F = 100 (all three on
    # WMMA) (ROUTED)
    gmlp_bf16_shapes = gmlp_shapes + [(3, 20, 36, 72), (2, 13, 44, 100)]
    # the W8A8 gMLP block's token product is one launch over the images (a
    # 3-D tensor map for all but the last, a 2-D one for the last), so it is
    # also held at the batches the path runs it at: b128 and b131
    gmlp_int8_shapes = gmlp_shapes + [(128, 196, 256, 1536), (131, 196, 256, 1536)]
    return {
        "fused_mixer_block": (
            mods["mixer_block"], "fused_mixer_block", "mixer_block_ref", block_inputs,
            fwd_shapes, "mixer_block.cu", "mixer_block.py:157", DEPTH),
        "fused_mixer_block_int8": (
            mods["mixer_block_int8"], "fused_mixer_block_int8", "mixer_block_int8_ref",
            block_inputs, mixer_shapes + [(2, 33, 136, 50, 2056)],
            "mixer_block_int8.cu", "mixer_block_int8.py:121", DEPTH),
        "fused_resmlp_block": (
            mods["resmlp_block"], "fused_resmlp_block", "resmlp_block_ref", resmlp_inputs,
            res_bf16_shapes, "resmlp_block.cu", "resmlp_block.py:54", RES_DEPTH),
        "fused_resmlp_block_int8": (
            mods["resmlp_block_int8"], "fused_resmlp_block_int8", "resmlp_block_int8_ref",
            resmlp_inputs, res_int8_shapes, "resmlp_block_int8.cu", "resmlp_block_int8.py:69",
            RES_DEPTH),
        "fused_gmlp_block": (
            mods["gmlp_block"], "fused_gmlp_block", "gmlp_block_ref", gmlp_inputs,
            gmlp_bf16_shapes, "gmlp_block.cu", "gmlp_block.py:57", GMLP_DEPTH),
        "fused_gmlp_block_int8": (
            mods["gmlp_block_int8"], "fused_gmlp_block_int8", "gmlp_block_int8_ref",
            gmlp_inputs, gmlp_int8_shapes, "gmlp_block_int8.cu", "gmlp_block_int8.py:61",
            GMLP_DEPTH),
        **{k: (mods["mixer_block_bwd"], k, f"{k}_ref", train_inputs(k),
               fwd_shapes + TRAIN_SHAPES,
               "mixer_block_bwd.cu", replaced, DEPTH)
           for k, replaced in TRAIN_KERNELS.items()},
    }


def launches(mod, fn):
    """The launch count of wrapper fn of a kernel module."""
    return mod.LAUNCHES[fn] if isinstance(mod.LAUNCHES, dict) else mod.LAUNCHES


def outputs(got):
    return got if isinstance(got, tuple) else (got,)


def grouping(mod, fn, x, w):
    """(images per f32 partial, partials, images in the last) of a
    weight-gradient kernel's sums over images, as the kernel groups them."""
    per = mod.images_per_group(fn, x, w[GROUPED[fn]].shape[0])
    n = -(-x.shape[0] // per)
    return per, n, x.shape[0] - (n - 1) * per


def gemm_inputs(M, N, K, residual, seed):
    """a (M, K), b (N, K), bias (N,) and the keyword of one epilogue, bf16 on
    the card, scaled as block_inputs scales a channel product's."""
    rn, lin = _draw(seed)
    b, bias = lin(N, K)
    kw = {"residual": rn(M, N)} if residual else {"act": "gelu_tanh"}
    return rn(M, K), b, bias, kw


def phase_gemm(mod):
    """Phase 2 for the GEMM core of the channel products: gemm_tn on the
    auto route at GEMM_SHAPES (each counted on the wgmma core) and on the
    WMMA core at the first two, at GEMM_WMMA_SHAPE on the auto route
    (counted on the WMMA core; the wgmma core refuses it), both epilogues:
    within TOL of max(1, max|ref|) of gemm_tn_ref, two calls bit-equal, one
    launch a call. Returns the largest max|Δ|."""
    worst = 0.0
    cases = ([(shape, "auto", "sm90") for shape in GEMM_SHAPES]
             + [(shape, "legacy", "wmma") for shape in GEMM_SHAPES[:2]]
             + [(GEMM_WMMA_SHAPE, "auto", "wmma")])
    for shape, core, route in cases:
        for residual in (False, True):
            a, b, bias, kw = gemm_inputs(*shape, residual, seed=sum(shape) + residual)
            tag = f"gemm_tn {shape} {'residual' if residual else 'gelu_tanh'} core={core}"
            before, routes0 = mod.LAUNCHES, mod.routes()
            got = mod.gemm_tn(a, b, bias, core=core, **kw)
            torch.cuda.synchronize()
            again = mod.gemm_tn(a, b, bias, core=core, **kw)
            torch.cuda.synchronize()
            routes1 = mod.routes()
            moved = {k: routes1[k] - routes0[k] for k in routes1}
            want_routes = {k: 2 * (k == route) for k in routes1}
            check(mod.LAUNCHES == before + 2, f"{tag}: LAUNCHES did not rise by 1 a call")
            check(moved == want_routes, f"{tag}: routes {moved}, want {want_routes}")
            check(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
            want = mod.gemm_tn_ref(a, b, bias, **kw)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            rel = err / max(1.0, want.float().abs().max().item())
            worst = max(worst, err)
            print(f"[2] {tag} vs twin: max|d|/max(1,max|ref|) {rel:.6g} (limit {TOL}); two calls "
                  f"bit-equal; on the {route} core ({json.dumps(moved)})", flush=True)
            check(rel <= TOL, f"{tag} disagrees with its twin: {rel}")
            del a, b, bias, kw, got, again, want
    a, b, bias, kw = gemm_inputs(*GEMM_WMMA_SHAPE, False, seed=0)
    try:
        mod.gemm_tn(a, b, bias, core="sm90", **kw)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, f"gemm_tn core=sm90 at {GEMM_WMMA_SHAPE} (rows 100 bytes apart) did not raise")
    print(f"[2] gemm_tn core=sm90 at {GEMM_WMMA_SHAPE}: refused (TMA needs 16-byte row strides)",
          flush=True)
    return worst


# The core's bf16 modes alone (gemm_bf16): Mixer-B/16's four channel
# backward products at B = 8 (rows 1568, slabs of 4 images: 2 partials) as
# (M, N, K, a_mn, b_mn, slab): hn·Wc1ᵀ, g·Wc2 (Wc2 N-major), dcpᵀ·hn and
# gᵀ·c (both operands MN-major, row slabs); then ragged ones (M, N against
# the 192 tile, K against the 64-row step): an MN-major A alone, slabs of
# 66 rows over 165 (the last 33), one slab; and rows 72 bytes apart
# (M = 36), which take the WMMA route with the same slabs.
CORE_BF16 = [(1568, 3072, 768, False, False, None), (1568, 3072, 768, False, True, None),
             (3072, 768, 1568, True, True, 784), (768, 3072, 1568, True, True, 784),
             (200, 72, 136, True, False, None), (200, 136, 165, True, True, 66),
             (40, 200, 136, True, True, None)]
CORE_BF16_WMMA = (36, 50, 100, True, True, 40)
# The bf16 gMLP block's three products alone (gemm_bf16 with batch
# entries) at gMLP-S's B = 8, as (entries, M, N, K, A's row length, b_mn):
# GEMM1 (B·N rows, 2F, D), the token product per image (Wsp shared, in rows
# of Np = 200 read as its first N = 196 columns; vn an N-major entry an
# image) and GEMM2 (B·N, D = 256 against the 192 tile, F); then a ragged
# token product (N = 20 in rows of 24, F = 72).
GMLP_BF16 = [(1, 1568, 3072, 256, 256, False), (8, 196, 1536, 196, 200, True),
             (1, 1568, 256, 1536, 1536, False), (3, 20, 72, 20, 24, True)]
GMLP_BF16_TIMED = [(1, 256 * 196, 3072, 256, 256, False), (256, 196, 1536, 196, 200, True),
                   (1, 256 * 196, 256, 1536, 1536, False)]
# The core's int8 form alone (gemm_s8) at gMLP-S's three products at B = 8:
# (entries, M, N, K, a batched, b batched, chunk): GEMM1 (B·N rows, 2F, Dp),
# the token product per image (qWsp shared, qv an entry an image: N, F,
# Np) and GEMM2 (B·N, D = 256 against a 192-wide tile, Fp); then ragged
# ones.
CORE_S8 = [(1, 1568, 3072, 256, False, False, None), (8, 196, 1536, 224, False, True, None),
           (1, 1568, 256, 1536, False, False, None), (1, 97, 72, 64, False, False, None),
           (3, 20, 200, 32, True, True, None), (1, 1, 3072, 288, False, False, None)]
# The W8A8 Mixer block's four products alone at Mixer-B/16's B = 8: the two
# token products per image (the weight shared, the codes an entry an image:
# TD × D over Np, N × D over TDp), the first channel product (B·N, CD, Dp)
# and the second in the chunked mode (B·N, D, 4 chunks of 768 codes); then
# the chunked mode at the ragged chunk of phase 2's (2, 33, 136, 50, 2056)
# block (4 chunks of ck 514 padded to 544 codes, each ending inside a
# 128-code K step; M and N ragged against the 192×96 tile), at one chunk,
# and with batched entries and 32-code chunks.
MIXER_S8 = [(8, 384, 768, 224, False, True, None), (8, 196, 768, 384, False, True, None),
            (1, 1568, 3072, 768, False, False, None), (1, 1568, 768, 3072, False, False, 768),
            (1, 66, 136, 2176, False, False, 544), (1, 97, 40, 96, False, False, 96),
            (3, 20, 100, 128, True, True, 32)]
# The ResMLP blocks' three products alone at ResMLP-S24's B = 8 (N = 196,
# D = 384, F = 1536): bf16 as GMLP_BF16's (entries, M, N, K, A's row length,
# b_mn): the token product per image (Wt shared, in rows of Np = 200 read as
# its first 196 columns; h an N-major entry an image), FF1 (B·N, F, D), FF2
# (B·N, D = two whole 192-wide tiles, F); int8 as CORE_S8's: the token
# product (qWt shared, qh an entry an image: N, D, Np), FF1 (B·N, F, Dp),
# FF2 (B·N, D, F: one chunk at F = 1536)
RES_BF16 = [(8, 196, 384, 196, 200, True), (1, 1568, 1536, 384, 384, False),
            (1, 1568, 384, 1536, 1536, False)]
RES_BF16_TIMED = [(256, 196, 384, 196, 200, True), (1, 256 * 196, 1536, 384, 384, False),
                  (1, 256 * 196, 384, 1536, 1536, False)]
RES_S8 = [(8, 196, 384, 224, False, True, None), (1, 1568, 1536, 384, False, False, None),
          (1, 1568, 384, 1536, False, False, None)]
RES_S8_TIMED = [(256, 196, 384, 224, False, True, None),
                (1, 256 * 196, 1536, 384, False, False, None),
                (1, 256 * 196, 384, 1536, False, False, None)]
# b256's products for phase 5 (and phase 2): gMLP-S's three (int8), the W8A8
# Mixer-B/16 block's four, gMLP-S's three bf16 ones and Mixer-B/16's four
# channel backward ones (bf16; slabs of 128 images, as on an H100)
CORE_S8_TIMED = [(1, 256 * 196, 3072, 256, False, False, None),
                 (256, 196, 1536, 224, False, True, None),
                 (1, 256 * 196, 256, 1536, False, False, None)]
MIXER_S8_TIMED = [(256, 384, 768, 224, False, True, None), (256, 196, 768, 384, False, True, None),
                  (1, 256 * 196, 3072, 768, False, False, None),
                  (1, 256 * 196, 768, 3072, False, False, 768)]
CORE_BF16_TIMED = [(256 * 196, 3072, 768, False, False, None),
                   (256 * 196, 3072, 768, False, True, None),
                   (3072, 768, 256 * 196, True, True, 128 * 196),
                   (768, 3072, 256 * 196, True, True, 128 * 196)]
S8_REPLACES = PALLAS + "gmlp_block_int8.py:61 (the products of fused_gmlp_block_int8)"
MIXER_S8_REPLACES = PALLAS + "mixer_block_int8.py:121 (the products of fused_mixer_block_int8)"
GMLP_BF16_REPLACES = PALLAS + "gmlp_block.py:57 (the products of fused_gmlp_block)"
RES_BF16_REPLACES = PALLAS + "resmlp_block.py:54 (the products of fused_resmlp_block)"
RES_S8_REPLACES = PALLAS + "resmlp_block_int8.py:69 (the products of fused_resmlp_block_int8)"
BWD_REPLACES = (PALLAS + "mixer_block_bwd.py:397 (the products of _chan_wgt_bwd; with :220 "
                "and :306, the products of _token_bwd and _chan_data_bwd)")
DUAL_REPLACES = (PALLAS + "mixer_block_bwd.py:220 (_token_bwd's recompute and Wt2ᵀ·dh products) "
                 "and :306 (_chan_data_bwd's cp and dc products)")
GROUP_REPLACES = PALLAS + "mixer_block_bwd.py:220 (_token_bwd's dWt1 and dWt2 sums over images)"
# The core's dual mode alone (gemm_bf16_dual), as (entries, M, N, K, the A
# operands' row length, a_mn, b_mn, A batched, B batched): Mixer-B/16's two
# pairs at B = 8, the channel data backward's (hn·Wc1ᵀ, g·Wc2 with Wc2ᵀ
# K-major; 192×96 tiles) and the token backward's (Wt1·xn_b, Wt2ᵀ·dh_b:
# the weights shared in rows of Np = 200, xn and dh N-major an entry an
# image; 192×64 tiles); ragged ones (M, N against the tile, K against the
# 64-wide step; an MN-major A); rows 72 bytes apart (K = 36), the WMMA
# route; and b256's two pairs.
DUAL = [(1, 1568, 3072, 768, 768, False, False, False, False),
        (8, 384, 768, 196, 200, False, True, False, True),
        (1, 97, 200, 136, 136, False, False, False, False),
        (3, 50, 136, 33, 40, False, True, False, True),
        (2, 200, 72, 40, 200, True, True, False, True)]
DUAL_WMMA = (1, 36, 40, 36, 36, False, False, False, False)
DUAL_TIMED = [(1, 256 * 196, 3072, 768, 768, False, False, False, False),
              (256, 384, 768, 196, 200, False, True, False, True)]
# The core's Group mode alone (gemm_bf16_group): the token backward's dWt2
# (M = N tokens, N = TD) and dWt1 (TD, N) over images of K = D, at B = 8,
# b128 and b131 in the kernel's groups (the token backward's
# images_per_group), as (images, M, N, K, per or None for the kernel's);
# a ragged one in groups of 2 (the last of 1); rows 72 bytes apart (K =
# 36), the WMMA route's gemm_sum; and b256's two for phase 5.
GROUP = [(B, M, N, 768, None) for B in (8, 128, 131) for M, N in ((196, 384), (384, 196))] + [
    (5, 33, 50, 136, 2)]
GROUP_WMMA = (5, 20, 24, 36, 2)
GROUP_TIMED = [(256, 196, 384, 768, None), (256, 384, 196, 768, None)]


def bf16_core_inputs(M, N, K, a_mn, b_mn, seed):
    """bf16 operands of gemm_bf16 on the card, O(1) products: a (M, K) or
    (K, M), b (N, K) or (K, N), b scaled by 1/sqrt(K)."""
    rn, _ = _draw(seed)
    a = rn(K, M) if a_mn else rn(M, K)
    b = rn(K, N, scale=K ** -0.5) if b_mn else rn(N, K, scale=K ** -0.5)
    return a, b


def gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed):
    """bf16 operands of one of the bf16 gMLP block's products: a (M, K), a
    view of rows lda long (the columns past K random: the kernel must not
    read them), shared; b (N, K), or with b_mn (nz, K, N), an entry an
    image; b scaled by 1/sqrt(K)."""
    rn, _ = _draw(seed)
    a = rn(M, lda)[:, :K]
    b = rn(nz, K, N, scale=K ** -0.5) if b_mn else rn(N, K, scale=K ** -0.5)
    return a, b


def s8_core_inputs(nz, M, N, K, a_batched, b_batched, chunk, seed):
    """int8 codes in [-127, 127] and f32 scales of gemm_s8 on the card: rs
    per row (per row and chunk of K with ``chunk``), cs per column, each
    batched where its operand is."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def codes(*shape):
        q = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int32)
        return q.to(torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=g, device="cuda") * 2e-3 + 1e-4

    pieces = () if chunk is None else (K // chunk,)
    a = codes(nz, M, K) if a_batched else codes(M, K)
    b = codes(nz, N, K) if b_batched else codes(N, K)
    rs = scales(nz, M, *pieces) if a_batched else scales(M, *pieces)
    cs = scales(nz, N) if b_batched else scales(N)
    return a, b, rs, cs


def dual_core_inputs(nz, M, N, K, lda, a_mn, b_mn, a_batched, b_batched, seed):
    """bf16 operands of gemm_bf16_dual on the card, O(1) products: a1, a2
    (M, K) or (K, M), shared views of rows lda long (the columns past them
    random: the kernel must not read them) or batched; b1, b2 (N, K) or
    (K, N), scaled by 1/sqrt(K), shared or batched."""
    rn, _ = _draw(seed)

    def a():
        rows, cols = (K, M) if a_mn else (M, K)
        return rn(nz, rows, cols) if a_batched else rn(rows, lda)[:, :cols]

    def b():
        shape = (K, N) if b_mn else (N, K)
        return rn(*((nz,) if b_batched else ()), *shape, scale=K ** -0.5)

    return a(), b(), a(), b()


def group_inputs(images, M, N, K, seed):
    """a (images, M, K) and b (images, N, K) bf16 on the card, b scaled by
    1/sqrt(K)."""
    rn, _ = _draw(seed)
    return rn(images, M, K), rn(images, N, K, scale=K ** -0.5)


def token_group(bwd, images, M, N, K):
    """Images per partial of the token backward's dWt1 and dWt2 at images
    of (tokens, D) = (min(M, N), K) and TD = max(M, N) on this card."""
    x = torch.empty((images, min(M, N), K), dtype=torch.bfloat16, device="cuda")
    return bwd.images_per_group("token_bwd", x, max(M, N))


def _core_case(mod, tag, call, twin, route_fn, want_moved, exact=False):
    """One core-mode case: launched twice (bit-equal, one launch each, the
    routes moved as wanted), held within TOL of max(1, max|ref|) of its
    twin, or with ``exact`` bit-equal to it. Returns max|Δ|."""
    before, routes0 = mod.LAUNCHES, route_fn()
    got = call()
    torch.cuda.synchronize()
    again = call()
    torch.cuda.synchronize()
    routes1 = route_fn()
    moved = {k: routes1[k] - routes0[k] for k in routes1}
    check(mod.LAUNCHES == before + 2, f"{tag}: LAUNCHES did not rise by 1 a call")
    check(moved == want_moved, f"{tag}: routes {moved}, want {want_moved}")
    check(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
    want = twin()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(1.0, want.float().abs().max().item())
    limit = "bit-equal" if exact else f"limit {TOL}"
    print(f"[2] {tag} vs twin: max|d|/max(1,max|ref|) {rel:.6g} (max|d| {err:.6g}; {limit}); "
          f"two calls bit-equal; routes {json.dumps(moved)}", flush=True)
    if exact:
        check(torch.equal(got, want), f"{tag} is not bit-equal to its twin: max|d| {err}")
    check(rel <= TOL, f"{tag} disagrees with its twin: {rel}")
    return err


def phase_modes(mod, bwd):
    """Phase 2 for the core's two modes of the Mixer backwards alone: the
    dual mode (gemm_bf16_dual) at DUAL and DUAL_TIMED on the auto route
    (counted as two products on the wgmma core a call), at the first two on
    the WMMA core and at DUAL_WMMA on the auto route (the WMMA route); the
    Group mode (gemm_bf16_group) at GROUP in the token backward's groups on
    the auto route, at the b131 dWt2 on the WMMA core (gemm_sum in the same
    groups) and at GROUP_WMMA on the auto route (the WMMA route). Each
    within TOL of its twin, two calls bit-equal; the Group mode's
    partials of several images and a short last one must occur. Returns
    each row's largest max|Δ|."""
    worst = {"gemm_bf16_dual_sm90": 0.0, "gemm_bf16_group_sm90": 0.0}

    def moved(route, products):
        return {"sm90": (route == "sm90") * 2 * products, "wmma": (route == "wmma") * 2 * products}

    cases = ([(c, "auto", "sm90") for c in DUAL + DUAL_TIMED]
             + [(c, "legacy", "wmma") for c in DUAL[:2]] + [(DUAL_WMMA, "auto", "wmma")])
    for case, core, route in cases:
        nz, M, N, K, lda, a_mn, b_mn, ab, bb = case
        a1, b1, a2, b2 = dual_core_inputs(*case, seed=nz + M + N + K)
        kw = dict(a_mn=a_mn, b_mn=b_mn)
        tag = (f"gemm_bf16_dual {nz} x (M, N, K) {(M, N, K)} A rows of {lda} a_mn={a_mn} "
               f"b_mn={b_mn} a_batched={ab} b_batched={bb} core={core}")
        worst["gemm_bf16_dual_sm90"] = max(worst["gemm_bf16_dual_sm90"], _core_case(
            mod, tag, lambda: torch.stack(mod.gemm_bf16_dual(a1, b1, a2, b2, core=core, **kw)),
            lambda: torch.stack(mod.gemm_bf16_dual_ref(a1, b1, a2, b2, **kw)), mod.routes,
            moved(route, 2)))
        del a1, b1, a2, b2
        torch.cuda.empty_cache()
    groups = []
    cases = ([(c, "auto", "sm90") for c in GROUP] + [(GROUP[4], "legacy", "wmma")]
             + [(GROUP_WMMA, "auto", "wmma")])
    for (images, M, N, K, per), core, route in cases:
        per = per or token_group(bwd, images, M, N, K)
        a, b = group_inputs(images, M, N, K, seed=images + M + N + K)
        n = -(-images // per)
        last = images - (n - 1) * per
        if route == "sm90":
            groups.append((per, n, last))
        tag = (f"gemm_bf16_group {images} images (M, N, K) {(M, N, K)} in {n} partials of {per} "
               f"(last {last}) core={core}")
        worst["gemm_bf16_group_sm90"] = max(worst["gemm_bf16_group_sm90"], _core_case(
            mod, tag, lambda: mod.gemm_bf16_group(a, b, per, core=core),
            lambda: mod.gemm_bf16_group_ref(a, b, per), mod.routes, moved(route, 1)))
        del a, b
    check(any(per > 1 for per, _, _ in groups) and any(last < per for per, _, last in groups),
          f"gemm_bf16_group: no case summed several images in a partial and left a short last "
          f"one: {groups}")
    return worst


def phase_core(mod):
    """Phase 2 for the core's modes alone: gemm_bf16 at CORE_BF16 on the
    auto route (each counted on the wgmma core; the first four also on the
    WMMA core) and at CORE_BF16_WMMA (counted on the WMMA route; core="sm90"
    must raise), each partial within TOL of gemm_bf16_ref's; gemm_bf16 at
    the bf16 gMLP and ResMLP blocks' products (GMLP_BF16, RES_BF16, and
    at b256) on the auto route (those at B = 8 also on WMMA), within TOL;
    gemm_s8 at CORE_S8, MIXER_S8 (the chunked mode among them), RES_S8 and
    at b256 (CORE_S8_TIMED, MIXER_S8_TIMED, RES_S8_TIMED) on the s8 wgmma
    core (the first three of CORE_S8, the two Mixer chunked ones at B = 8
    and the ragged chunk, and RES_S8, also on mma.sync), bit-equal to
    gemm_s8_ref: the integer product is exact and the scales are applied,
    and the chunks added, in the twin's order. Returns each core row's
    largest max|Δ|."""
    worst = dict.fromkeys(("gemm_bwd_sm90", "gemm_bf16_gmlp_sm90", "gemm_s8_sm90",
                           "gemm_s8_mixer_sm90", "gemm_bf16_resmlp_sm90",
                           "gemm_s8_resmlp_sm90"), 0.0)

    def bf16_routes(route):
        return {"sm90": (route == "sm90") * 2, "wmma": (route == "wmma") * 2}

    cases = ([(c, "auto", "sm90") for c in CORE_BF16] + [(c, "legacy", "wmma") for c in CORE_BF16[:4]]
             + [(CORE_BF16_WMMA, "auto", "wmma")])
    for (M, N, K, a_mn, b_mn, slab), core, route in cases:
        a, b = bf16_core_inputs(M, N, K, a_mn, b_mn, seed=M + N + K)
        kw = dict(a_mn=a_mn, b_mn=b_mn, slab=slab)
        tag = f"gemm_bf16 (M, N, K) {(M, N, K)} a_mn={a_mn} b_mn={b_mn} slab={slab} core={core}"
        worst["gemm_bwd_sm90"] = max(worst["gemm_bwd_sm90"], _core_case(
            mod, tag, lambda: mod.gemm_bf16(a, b, core=core, **kw),
            lambda: mod.gemm_bf16_ref(a, b, **kw), mod.routes, bf16_routes(route)))
        del a, b
    M, N, K, a_mn, b_mn, slab = CORE_BF16_WMMA
    a, b = bf16_core_inputs(M, N, K, a_mn, b_mn, seed=1)
    try:
        mod.gemm_bf16(a, b, a_mn=a_mn, b_mn=b_mn, slab=slab, core="sm90")
        refused = False
    except RuntimeError:
        refused = True
    check(refused, f"gemm_bf16 core=sm90 at {CORE_BF16_WMMA} (rows 72 bytes apart) did not raise")
    print(f"[2] gemm_bf16 core=sm90 at {CORE_BF16_WMMA}: refused (TMA needs 16-byte row strides)",
          flush=True)
    cases = ([(c, "auto", "sm90", "gMLP", "gemm_bf16_gmlp_sm90")
              for c in GMLP_BF16 + GMLP_BF16_TIMED]
             + [(c, "legacy", "wmma", "gMLP", "gemm_bf16_gmlp_sm90") for c in GMLP_BF16[:3]]
             + [(c, "auto", "sm90", "ResMLP", "gemm_bf16_resmlp_sm90")
                for c in RES_BF16 + RES_BF16_TIMED]
             + [(c, "legacy", "wmma", "ResMLP", "gemm_bf16_resmlp_sm90") for c in RES_BF16])
    for (nz, M, N, K, lda, b_mn), core, route, block, row in cases:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=nz + M + N + K)
        tag = (f"gemm_bf16 {nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn} "
               f"(the bf16 {block} block's) core={core}")
        worst[row] = max(worst[row], _core_case(
            mod, tag, lambda: mod.gemm_bf16(a, b, b_mn=b_mn, core=core),
            lambda: mod.gemm_bf16_ref(a, b, b_mn=b_mn), mod.routes, bf16_routes(route)))
        del a, b
    cases = ([(c, "auto", "sm90_s8", "gemm_s8_sm90") for c in CORE_S8 + CORE_S8_TIMED]
             + [(c, "legacy", "mma_s8", "gemm_s8_sm90") for c in CORE_S8[:3]]
             + [(c, "auto", "sm90_s8", "gemm_s8_mixer_sm90") for c in MIXER_S8 + MIXER_S8_TIMED]
             + [(c, "legacy", "mma_s8", "gemm_s8_mixer_sm90") for c in MIXER_S8[3:5]]
             + [(c, "auto", "sm90_s8", "gemm_s8_resmlp_sm90") for c in RES_S8 + RES_S8_TIMED]
             + [(c, "legacy", "mma_s8", "gemm_s8_resmlp_sm90") for c in RES_S8])
    for (nz, M, N, K, ab, bb, chunk), core, route, row in cases:
        a, b, rs, cs = s8_core_inputs(nz, M, N, K, ab, bb, chunk, seed=nz + M + N + K)
        tag = (f"gemm_s8 {nz} x (M, N, K) {(M, N, K)} a_batched={ab} b_batched={bb} "
               f"chunk={chunk} core={core}")
        worst[row] = max(worst[row], _core_case(
            mod, tag, lambda: mod.gemm_s8(a, b, rs, cs, chunk=chunk, core=core),
            lambda: mod.gemm_s8_ref(a, b, rs, cs, chunk=chunk), mod.s8_routes,
            {"sm90_s8": (route == "sm90_s8") * 2, "mma_s8": (route == "mma_s8") * 2}, exact=True))
        del a, b, rs, cs
        torch.cuda.empty_cache()
    return worst


def phase_kernels(table):
    """Each kernel vs its twin at its shapes, every output; two calls agree
    bit for bit. The weight-gradient kernels must have summed several images
    into one partial, and a short last partial, at some shape; chan_wgt_bwd's
    twin sums in the kernel's slabs. Returns name → largest max|Δ|."""
    errs = {}
    for name, (mod, fn, ref, inputs, shapes, *_rest) in table.items():
        errs[name] = 0.0
        groups = []
        for shape in shapes:
            x, w = inputs(*shape, seed=sum(shape))
            before = launches(mod, fn)
            routes0 = mod.routes() if name in ROUTED else None
            got = outputs(getattr(mod, fn)(x, *w))
            torch.cuda.synchronize()
            check(launches(mod, fn) == before + 1, f"{name}: LAUNCHES did not rise by 1 at {shape}")
            again = outputs(getattr(mod, fn)(x, *w))
            torch.cuda.synchronize()
            note = ""
            if routes0 is not None:  # two calls
                routes1 = mod.routes()
                moved = {k: routes1[k] - routes0[k] for k in routes1}
                want_routes = {k: 2 * v for k, v in ROUTED[name](shape).items()}
                check(moved == want_routes,
                      f"{name}: products on {moved} at {shape}, want {want_routes}")
                note = f"; products of two calls {json.dumps(moved)}"
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: two calls on the same inputs differ at {shape}")
            kw = {}
            if fn in GROUPED:
                groups.append(grouping(mod, fn, x, w))
                note += (f"; weight gradients in {groups[-1][1]} partials of {groups[-1][0]} "
                         f"images (last {groups[-1][2]})")
                # each twin sums in the kernel's slabs or groups, in order
                kw = {"images_per_slab" if fn == "chan_wgt_bwd" else "images_per_group":
                      groups[-1][0]}
            want = outputs(getattr(mod, ref)(x, *w, **kw))
            check(len(got) == len(want), f"{name}: {len(got)} outputs, twin {len(want)}")
            rels = []
            for i, (a, b) in enumerate(zip(got, want)):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{name}: output {i} {tuple(a.shape)} {a.dtype}, twin {tuple(b.shape)} "
                      f"{b.dtype} at {shape}")
                check(bool(torch.isfinite(a).all()), f"{name}: non-finite output {i} at {shape}")
                err = (a.float() - b.float()).abs().max().item()
                rels.append(err / max(1.0, b.float().abs().max().item()))
                errs[name] = max(errs[name], err)
            print(f"[2] {name} vs twin {shape}: max|d|/max(1,max|ref|) per output "
                  f"{' '.join(f'{r:.6g}' for r in rels)} (limit {TOL}); two calls bit-equal"
                  f"{note}", flush=True)
            check(max(rels) <= TOL, f"{name} disagrees with its twin at {shape}: {rels}")
            del x, w, got, again, want
        if fn in GROUPED:
            check(any(per > 1 for per, _, _ in groups) and any(last < per for per, _, last in groups),
                  f"{name}: no shape summed several images in a partial and left a short last "
                  f"one: {groups}")
    return errs


def shift_input(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def phase_shift(mod):
    """The axial shift against its twin at SHIFT_SHAPES, both axes, both
    signs, bf16 and float32: bit-equal (it is a copy), two calls agree, and
    each call launches the kernel once. Then the autograd wrapper: forward
    at sign +1, and its backward on a non-contiguous gradient equals the
    twin at sign -1. Returns the largest max|Δ| (0 when it passes)."""
    worst = 0.0
    for shape, shift in SHIFT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = shift_input(shape, dtype, seed=sum(shape))
            for axis in (1, 2):
                for sign in (1, -1):
                    tag = f"axial_shift {shape} shift {shift} axis {axis} sign {sign} {dtype}"
                    before = mod.LAUNCHES
                    got = mod.shift(x, shift, axis, sign)
                    torch.cuda.synchronize()
                    check(mod.LAUNCHES == before + 1, f"{tag}: LAUNCHES did not rise by 1")
                    again = mod.shift(x, shift, axis, sign)
                    want = mod.axial_shift_ref(x, shift, axis, sign)
                    torch.cuda.synchronize()
                    check(got.shape == want.shape and got.dtype == want.dtype,
                          f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
                    check(torch.equal(got, again), f"{tag}: two calls differ")
                    worst = max(worst, (got.float() - want.float()).abs().max().item())
                    check(torch.equal(got, want), f"{tag}: differs from its twin")
        print(f"[2] axial_shift vs twin {shape} shift {shift}: axes H and W, signs +1 and -1, "
              f"bf16 and f32: bit-equal; two calls bit-equal", flush=True)
    x = shift_input((8, 56, 56, 96), torch.bfloat16, seed=3).requires_grad_()
    g = shift_input((8, 56, 56, 96), torch.bfloat16, seed=4).transpose(1, 2)
    for axis in (1, 2):
        y = mod.axial_shift(x, 5, axis)
        (dx,) = torch.autograd.grad(y, x, g)
        check(not g.is_contiguous() and torch.equal(y, mod.axial_shift_ref(x.detach(), 5, axis))
              and torch.equal(dx, mod.axial_shift_ref(g.contiguous(), 5, axis, -1)),
              f"axial_shift autograd wrapper, axis {axis}: forward or backward differs")
    print("[2] axial_shift autograd wrapper (8, 56, 56, 96) bf16, both axes: forward = twin, "
          "backward on a non-contiguous gradient = twin at sign -1, bit-equal", flush=True)
    return worst


def lab_call(mod, fn, x, w, kw, twin=False):
    """A kernel-lab wrapper (or its twin) on x (B, N, D); the token-major
    kernel gets x relaid, and its output relaid back."""
    f = getattr(mod, f"{fn}_ref" if twin else fn)
    if fn == "tokmajor_block":
        return mod.from_tokmajor(f(mod.to_tokmajor(x, kw["bt"]), *w, **kw))
    return f(x, *w, **kw)


def lab_variants(fn):
    """{variant: keyword arguments} of every variant of the lab's table that
    runs the lab kernel ``fn``."""
    from jittor_mlp_tpu_torch.tools import kernel_lab as lab

    return {v: kw for v, (f, kw) in lab.VARIANTS.items() if f == fn}


def phase_lab(mod, names=None):
    """The kernel lab's kernels (or those in ``names``) against their twins
    at LAB_SHAPES, every bt and mode the lab runs: every output within TOL of
    max(1, max|ref|), two calls bit-equal, one launch a call. Returns name →
    largest max|Δ|."""
    errs = {}
    for fn in LAB_KERNELS:
        if names is not None and fn not in names:
            continue
        errs[fn] = 0.0
        for shape in LAB_SHAPES:
            x, w = block_inputs(*shape, seed=sum(shape))
            for vname, kw in lab_variants(fn).items():
                tag = f"{fn} ({vname}) {shape}"
                before = mod.LAUNCHES[fn]
                got = lab_call(mod, fn, x, w, kw)
                torch.cuda.synchronize()
                check(mod.LAUNCHES[fn] == before + 1, f"{tag}: LAUNCHES did not rise by 1")
                again = lab_call(mod, fn, x, w, kw)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
                want = lab_call(mod, fn, x, w, kw, twin=True)
                check(got.shape == want.shape == x.shape and got.dtype == want.dtype,
                      f"{tag}: {tuple(got.shape)} {got.dtype}, twin {tuple(want.shape)}")
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                rel = err / max(1.0, want.float().abs().max().item())
                errs[fn] = max(errs[fn], err)
                print(f"[2] {tag} vs twin: max|d|/max(1,max|ref|) {rel:.6g} (limit {TOL}); two "
                      f"calls bit-equal", flush=True)
                check(rel <= TOL, f"{tag} disagrees with its twin: {rel}")
                del got, again, want
            del x, w
            torch.cuda.empty_cache()
    return errs


def images(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, 3, 224, 224), np.float32)).to("cuda")


def rel_dev(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def compare_logits(tag, got, ref, lim_rel, lim_top1, phase="3"):
    """max|dlogit|/max|logit| ≤ lim_rel and top-1 agreement ≥ lim_top1
    (None: printed, not held)."""
    rel = rel_dev(got, ref)
    top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"[{phase}] {tag}: max|dlogit|/max|logit|={rel:.6g} top1 agreement={top1:.4f} "
          f"(64 images; limits {lim_rel}, {lim_top1})", flush=True)
    check(rel <= lim_rel and (lim_top1 is None or top1 >= lim_top1),
          f"{tag}: rel {rel}, top-1 {top1}")


def forward_counted(model, x, mod, want):
    """model.forward(x) in float32 logits; mod's kernel launched `want` times."""
    before = mod.LAUNCHES
    out = model.forward(x).float()
    torch.cuda.synchronize()
    check(mod.LAUNCHES == before + want,
          f"{mod.LAUNCHES - before} {mod.__name__} launches in one forward, want {want}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")
    return out


def check_routes(tag, before, after, products, route="sm90"):
    """Between two readings of a library's route counts, ``products`` products
    ran on ``route`` (by default the bf16 wgmma core) and none on any other
    core: at Mixer-B/16's and gMLP-S's shapes every operand is one TMA can
    load (D = 768, CD = 3072 rows are 16-byte multiples; int8 codes are
    padded to 32). Returns the products on ``route``."""
    moved = {k: after[k] - before[k] for k in after}
    want = {k: products if k == route else 0 for k in after}
    print(f"{tag}: products {json.dumps(moved)} (want {json.dumps(want)})", flush=True)
    check(moved == want, f"{tag}: products {moved}, want {want}")
    return moved[route]


def phase_logits(jt, mods):
    """Mixer-B/16, ResMLP-S24 and gMLP-S logits, kernel paths against plain
    paths. Returns the bf16 kernel-path models (on the card)."""
    from jittor_mlp_tpu_torch import config

    mb, mbq = mods["mixer_block"], mods["mixer_block_int8"]
    kernel = jt.MLPMixerForImageClassification(**MIXER_B16).to_bf16().eval()
    plain = jt.MLPMixerForImageClassification(**MIXER_B16, use_pallas=False).to_bf16().eval()
    f32 = jt.MLPMixerForImageClassification(**MIXER_B16).eval()
    x = images(64, 0)
    with torch.inference_mode():
        routes0 = mb.routes()
        lk = forward_counted(kernel, x.bfloat16(), mb, DEPTH)
        routes1 = mb.routes()
        q0 = mbq.routes()
        with config.int8_mode():
            lq = forward_counted(kernel, x.bfloat16(), mbq, DEPTH)
        check_routes("[3] Mixer-B/16 bf16 kernel-path forward", routes0, routes1, 2 * DEPTH)
        check(mb.routes() == routes1, "the int8 Mixer forward ran kernel 1's channel products")
        check_routes("[3] Mixer-B/16 int8 kernel-path forward", q0, mbq.routes(),
                     BLOCK_PRODUCTS["mixer_block_int8"][1] * DEPTH, route="sm90_s8")
        lp = plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            lf = f32.forward(x)
    check(lk.shape == (64, 1000), f"kernel-path logits {tuple(lk.shape)}")
    compare_logits("Mixer-B/16 kernel path vs plain bf16", lk, lp, 5e-2, 0.9)
    compare_logits("Mixer-B/16 kernel path vs f32 plain (TF32 off)", lk, lf, 5e-2, 0.9)
    compare_logits("Mixer-B/16 int8 kernel path vs bf16 kernel path", lq, lk, 0.1, 0.9)
    compare_logits("Mixer-B/16 int8 kernel path vs f32 plain (TF32 off)", lq, lf, 0.1, 0.9)
    del plain, f32

    rb, rbq = mods["resmlp_block"], mods["resmlp_block_int8"]
    sd = resmlp_state_dict(jt)
    res = jt.ResMLPForImageClassification(**RESMLP_S24).load_torch_state_dict(sd)
    res_plain = jt.ResMLPForImageClassification(**RESMLP_S24, use_pallas=False)
    res_plain = res_plain.load_torch_state_dict(sd).to_bf16().eval()
    res_f32 = jt.ResMLPForImageClassification(**RESMLP_S24).load_torch_state_dict(sd).eval()
    res = res.to_bf16().eval()
    with torch.inference_mode():
        r0 = rb.routes()
        rk = forward_counted(res, x.bfloat16(), rb, RES_DEPTH)
        check_routes("[3] ResMLP-S24 bf16 kernel-path forward", r0, rb.routes(),
                     BLOCK_PRODUCTS["resmlp_block"][1] * RES_DEPTH)
        rq0 = rbq.routes()
        with config.int8_mode():
            rq = forward_counted(res, x.bfloat16(), rbq, RES_DEPTH)
        check_routes("[3] ResMLP-S24 int8 kernel-path forward", rq0, rbq.routes(),
                     BLOCK_PRODUCTS["resmlp_block_int8"][1] * RES_DEPTH, route="sm90_s8")
        rp = res_plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            rf = res_f32.forward(x)
    compare_logits("ResMLP-S24 kernel path vs plain bf16", rk, rp, 5e-2, 0.9)
    compare_logits("ResMLP-S24 kernel path vs f32 plain (TF32 off)", rk, rf, 5e-2, 0.9)
    compare_logits("ResMLP-S24 int8 kernel path vs f32 plain (TF32 off)", rq, rf, 0.1, 0.9)
    del res_plain, res_f32

    gb, gbq = mods["gmlp_block"], mods["gmlp_block_int8"]
    gmlp = jt.gMLPForImageClassification(**GMLP_S).to_bf16().eval()
    g_plain = jt.gMLPForImageClassification(**GMLP_S, use_pallas=False).to_bf16().eval()
    g_f32 = jt.gMLPForImageClassification(**GMLP_S).eval()
    # every channel_proj2 zeroed: each block is then the identity
    g_ident = jt.gMLPForImageClassification(**GMLP_S).to_bf16().eval()
    with torch.no_grad():
        for blk in g_ident.model:
            blk.channel_proj2.weight.zero_()
            blk.channel_proj2.bias.zero_()
    with torch.inference_mode():
        g0 = gb.routes()
        gk = forward_counted(gmlp, x.bfloat16(), gb, GMLP_DEPTH)
        check_routes("[3] gMLP-S bf16 kernel-path forward", g0, gb.routes(),
                     BLOCK_PRODUCTS["gmlp_block"][1] * GMLP_DEPTH)
        s8_0 = gbq.routes()
        with config.int8_mode():
            gq = forward_counted(gmlp, x.bfloat16(), gbq, GMLP_DEPTH)
        check_routes("[3] gMLP-S int8 kernel-path forward", s8_0, gbq.routes(),
                     BLOCK_PRODUCTS["gmlp_block_int8"][1] * GMLP_DEPTH, route="sm90_s8")
        gz = forward_counted(g_ident, x.bfloat16(), gb, GMLP_DEPTH)
        gp = g_plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            gf = g_f32.forward(x)
    compare_logits("gMLP-S kernel path vs plain bf16", gk, gp, 5e-2, 0.9)
    compare_logits("gMLP-S kernel path vs f32 plain (TF32 off)", gk, gf, 5e-2, 0.9)
    compare_logits("gMLP-S int8 kernel path vs f32 plain (TF32 off)", gq, gf, 0.1, 0.9)
    moved, dev = rel_dev(gk, gz), rel_dev(gk, gf)
    print(f"[3] gMLP-S blocks move the logits: max|d|/max|logit| vs channel_proj2 zeroed "
          f"{moved:.6g}, kernel path vs f32 {dev:.6g} (need >= 10x)", flush=True)
    check(moved >= 10 * dev, f"gMLP-S blocks hardly move the logits: {moved} vs {dev}")
    del g_plain, g_f32, g_ident
    return kernel, res, gmlp, as_mlp_logits(jt, mods, x)


def as_mlp_logits(jt, mods, x):
    """AS-MLP-T logits on the images x: the bf16 kernel path against the
    plain bf16 path and float32 (TF32 off), int8 against float32, and the
    shift must matter. Returns the bf16 kernel-path model."""
    from jittor_mlp_tpu_torch import config

    sk = mods["axial_shift"]
    model = jt.AS_MLP(**AS_MLP_T).to_bf16().eval()
    plain = jt.AS_MLP(**AS_MLP_T, use_pallas=False).to_bf16().eval()
    f32 = jt.AS_MLP(**AS_MLP_T, use_pallas=False).eval()  # the reference: no kernel
    ident = jt.AS_MLP(**AS_MLP_T, shift_size=1).to_bf16().eval()  # one group, s = 0
    with torch.inference_mode():
        ak = forward_counted(model, x.bfloat16(), sk, SHIFTS)
        with config.int8_mode():
            aq = forward_counted(model, x.bfloat16(), sk, SHIFTS)
        az = forward_counted(ident, x.bfloat16(), sk, SHIFTS)
        before = sk.LAUNCHES
        ap = plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            af = f32.forward(x)
        check(sk.LAUNCHES == before, "a plain path launched the shift kernel")
    check(ak.shape == (64, 1000), f"AS-MLP-T logits {tuple(ak.shape)}")
    compare_logits("AS-MLP-T kernel path vs plain bf16", ak, ap, 5e-2, 0.9)
    compare_logits("AS-MLP-T kernel path vs f32 plain (TF32 off)", ak, af, 5e-2, 0.9)
    compare_logits("AS-MLP-T int8 kernel path vs f32 plain (TF32 off)", aq, af, 0.1, 0.9)
    moved, dev = rel_dev(ak, az), rel_dev(ak, af)
    print(f"[3] AS-MLP-T shift moves the logits: max|d|/max|logit| vs shift_size 1 (identity "
          f"shift) {moved:.6g}, kernel path vs f32 {dev:.6g} (need >= 10x); {SHIFTS} shift "
          f"launches a forward", flush=True)
    check(moved >= 10 * dev, f"AS-MLP-T: the shift hardly moves the logits: {moved} vs {dev}")
    return model


def resmlp_state_dict(jt):
    """ResMLP-S24's seed-0 weights with γ = 0.1 and perturbed affines
    (α = 1 + 0.1·randn, β = 0.1·randn, from numpy seed 5): at the factory's
    γ = 1e-5 the blocks would hardly move the logits, and a wrong block
    would go unseen."""
    sd = jt.ResMLPForImageClassification(**RESMLP_S24, device="cpu").export_torch_state_dict()
    rng = np.random.default_rng(5)
    for k, v in sd.items():
        if k.endswith(("gamma_1", "gamma_2")):
            sd[k] = torch.full_like(v, 0.1)
        elif k.endswith("alpha"):
            sd[k] = torch.from_numpy(1 + 0.1 * rng.standard_normal(v.shape, np.float32))
        elif k.endswith("beta"):
            sd[k] = torch.from_numpy(0.1 * rng.standard_normal(v.shape, np.float32))
    return sd


def reset_counts(mods):
    for mod in mods.values():
        if isinstance(mod.LAUNCHES, dict):
            mod.LAUNCHES.update(dict.fromkeys(mod.LAUNCHES, 0))
        else:
            mod.LAUNCHES = 0


def serve(jt, preds, imgs, threads=8, max_delay_ms=5.0):
    """Serve imgs through one MicroBatcher per Predictor, all at the same
    time: each of `threads` clients sends its share of the images to every
    batcher in turn. Checks each answer against predict() of the image
    alone. Returns the batchers' stats."""
    n = len(imgs)
    results = [[None] * n for _ in preds]
    errors = []
    batchers = [jt.MicroBatcher(p, max_delay_ms=max_delay_ms) for p in preds]

    def client(k):
        try:
            for i in range(k, n, threads):
                for j, b in enumerate(batchers):
                    results[j][i] = b.submit(imgs[i])
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
        check(not t.is_alive(), "a MicroBatcher client did not finish")
    stats = [b.stats() for b in batchers]
    for b in batchers:
        b.close()
    check(not errors, f"MicroBatcher request failed: {errors[:1]}")
    for j, p in enumerate(preds):
        check(all(r is not None for r in results[j]), "a request got no answer")
        for i in range(n):
            labels, probs = p.predict(imgs[i:i + 1])
            check(np.array_equal(results[j][i][0], labels[0]),
                  f"{p.dtype} request {i}: batched labels {results[j][i][0]} != alone {labels[0]}")
            check(np.abs(results[j][i][1] - probs[0]).max() <= 1e-3,
                  f"{p.dtype} request {i}: batched probs differ from predict alone")
    return stats


def check_launches(tag, mod, depth, pred):
    forwards = pred.latency_stats()["count"]
    print(f"{tag}: {mod.LAUNCHES} {mod.__name__.rsplit('.', 1)[1]} launches "
          f"({forwards} forwards x {depth} blocks)", flush=True)
    check(mod.LAUNCHES == depth * forwards,
          f"{tag}: {mod.LAUNCHES} launches for {forwards} forwards, want {depth} each")
    return mod.LAUNCHES


def phase_serving(jt, mods, mixer, res, gmlp, as_mlp):
    """(a) the bf16 Mixer serving run; (b), (c), (e), (g) int8 and bf16
    Predictors of one model served at the same time; (d), (f), (h)
    weights="int8". Each path runs with every launch count set to 0 just
    before it and read just after. Returns name → launches on that
    kernel's path."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    launches = {}

    # (a) Mixer-B/16 bf16, as the first slice serves it
    reset_counts(mods)  # the main path's run starts here
    routes0 = mods["mixer_block"].routes()  # a library's count is read, not reset
    pred = jt.Predictor(mixer, batch_size=32).warmup()
    stats = serve(jt, [pred], imgs)
    labels, probs = pred.predict(big)
    check(labels.shape == probs.shape == (2, 5) and np.isfinite(probs).all()
          and (probs >= 0).all() and (probs.sum(-1) <= 1 + 1e-5).all(),
          "resize-path requests gave malformed results")
    print("[4a] Mixer-B/16 bf16: 64 requests via MicroBatcher (8 threads) + 64 predict + "
          "2 resized (256x256); all answered, batched == alone", flush=True)
    print(f"[4a] MicroBatcher.stats: {json.dumps(stats[0])}", flush=True)
    print(f"[4a] Predictor.latency_stats: {json.dumps(pred.latency_stats())}", flush=True)
    launches["fused_mixer_block"] = check_launches("[4a] Mixer bf16", mods["mixer_block"],
                                                   DEPTH, pred)
    launches["gemm_tn_sm90"] = check_routes(
        "[4a] Mixer bf16", routes0, mods["mixer_block"].routes(),
        2 * launches["fused_mixer_block"])

    # (b), (c): an int8 and a bf16 Predictor on one model, at the same time
    for tag, model, bf_mod, q_mod, depth, bf_name, q_name in (
            ("[4b] Mixer-B/16", mixer, "mixer_block", "mixer_block_int8", DEPTH,
             "fused_mixer_block", "fused_mixer_block_int8"),
            ("[4c] ResMLP-S24", res, "resmlp_block", "resmlp_block_int8", RES_DEPTH,
             "fused_resmlp_block", "fused_resmlp_block_int8"),
            ("[4e] gMLP-S", gmlp, "gmlp_block", "gmlp_block_int8", GMLP_DEPTH,
             "fused_gmlp_block", "fused_gmlp_block_int8")):
        reset_counts(mods)
        routes0 = {lib: mods[lib].routes() for lib in BLOCK_PRODUCTS}
        p8 = jt.Predictor(model, batch_size=32, compute="int8").warmup()
        p16 = jt.Predictor(model, batch_size=32).warmup()
        check(p8.dtype == "int8" and p16.dtype == "bf16", f"{tag}: dtypes {p8.dtype}, {p16.dtype}")
        stats = serve(jt, [p8, p16], imgs)
        print(f"{tag} int8 + bf16 Predictors served at once: 64 requests each via "
              f"MicroBatcher (8 threads) + 64 predict each; batched == alone", flush=True)
        for p, s in zip((p8, p16), stats):
            print(f"{tag} {p.dtype} MicroBatcher.stats: {json.dumps(s)}; latency_stats: "
                  f"{json.dumps(p.latency_stats())}", flush=True)
        launches[q_name] = check_launches(f"{tag} int8", mods[q_mod], depth, p8)
        n16 = check_launches(f"{tag} bf16", mods[bf_mod], depth, p16)
        # every block library's GEMM routes: its products on the wgmma cores
        # where this pair ran its kernel, none elsewhere
        for lib, (route, per) in BLOCK_PRODUCTS.items():
            n = launches[q_name] if lib == q_mod else n16 if lib == bf_mod else 0
            moved = check_routes(f"{tag} {lib}", routes0[lib], mods[lib].routes(), per * n,
                                 route=route)
            if n and lib in PRODUCT_ROWS:
                launches[PRODUCT_ROWS[lib]] = moved
        if bf_name not in launches:
            launches[bf_name] = n16

    # (d), (f) weight-only int8: the dequantized weights serve close to bf16
    sd = resmlp_state_dict(jt)
    for tag, build_model, bf16_model in (
            ("[4d] ResMLP-S24", lambda: jt.ResMLPForImageClassification(
                **RESMLP_S24).load_torch_state_dict(sd), res),
            ("[4f] gMLP-S", lambda: jt.gMLPForImageClassification(**GMLP_S), gmlp)):
        pw = jt.Predictor(build_model(), batch_size=32, weights="int8")
        p16 = jt.Predictor(bf16_model, batch_size=32)
        lw, pw_probs = pw.predict(imgs[:32])
        l16, p16_probs = p16.predict(imgs[:32])
        top1 = float((lw[:, 0] == l16[:, 0]).mean())
        dprob = float(np.abs(pw_probs[:, 0] - p16_probs[:, 0]).max())
        print(f"{tag} weights=int8 vs bf16 Predictor, 32 images: top-1 agreement "
              f"{top1:.4f}, max |d top-1 prob| {dprob:.6g}", flush=True)
        check(pw.dtype == "bf16" and top1 >= 0.9 and dprob <= 5e-2,
              f"{tag} weights=int8 Predictor: top-1 {top1}, prob diff {dprob}")
        del pw
    launches["axial_shift"] = serve_as_mlp(jt, mods, as_mlp, imgs)
    return launches


def serve_as_mlp(jt, mods, model, imgs):
    """(g) AS-MLP-T int8 and bf16 Predictors on one model, served at the
    same time: the shift launches 24 times a forward of either; (h) its
    weights="int8" Predictor agrees with the bf16 one. Returns the shift's
    launches on (g)."""
    sk = mods["axial_shift"]
    reset_counts(mods)  # the AS-MLP serving path's run starts here
    p8 = jt.Predictor(model, batch_size=32, compute="int8").warmup()
    p16 = jt.Predictor(model, batch_size=32).warmup()
    check(p8.dtype == "int8" and p16.dtype == "bf16", f"[4g] dtypes {p8.dtype}, {p16.dtype}")
    stats = serve(jt, [p8, p16], imgs)
    print("[4g] AS-MLP-T int8 + bf16 Predictors served at once: 64 requests each via "
          "MicroBatcher (8 threads) + 64 predict each; batched == alone", flush=True)
    for p, st in zip((p8, p16), stats):
        print(f"[4g] AS-MLP-T {p.dtype} MicroBatcher.stats: {json.dumps(st)}; latency_stats: "
              f"{json.dumps(p.latency_stats())}", flush=True)
    forwards = p8.latency_stats()["count"] + p16.latency_stats()["count"]
    n = sk.LAUNCHES
    print(f"[4g] AS-MLP-T: {n} axial_shift launches ({forwards} forwards x {SHIFTS})", flush=True)
    check(n == SHIFTS * forwards, f"[4g] {n} shift launches for {forwards} forwards")
    pw = jt.Predictor(jt.AS_MLP(**AS_MLP_T), batch_size=32, weights="int8")
    lw, pw_probs = pw.predict(imgs[:32])
    l16, p16_probs = p16.predict(imgs[:32])
    top1 = float((lw[:, 0] == l16[:, 0]).mean())
    dprob = float(np.abs(pw_probs[:, 0] - p16_probs[:, 0]).max())
    print(f"[4h] AS-MLP-T weights=int8 vs bf16 Predictor, 32 images: top-1 agreement "
          f"{top1:.4f}, max |d top-1 prob| {dprob:.6g}", flush=True)
    check(pw.dtype == "bf16" and top1 >= 0.9 and dprob <= 5e-2,
          f"[4h] AS-MLP-T weights=int8 Predictor: top-1 {top1}, prob diff {dprob}")
    return n


def block_bound(name, x, w, outs):
    """(bound_ms, bound_by) of one kernel call from its inputs and outputs:
    each read once or written once at the HBM rate, against the call's
    products at the dense tensor-core peak of its type."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, *w, *outs))
    B, N, D = x.shape if x.dim() == 3 else (x.shape[0] * x.shape[2], x.shape[1], x.shape[3])
    bnd = 2 * B * N * D
    if name.startswith("fused_mixer_block") or name == "fwd_with_h" or name in LAB_KERNELS:
        TD, CD = w[2].shape[0], w[8].shape[0]
        ops = bnd * (2 * TD + 2 * CD)
    elif name == "token_bwd":  # w = (dh, ln1w, ln1b, wt1, bt1, wt2); with the recompute
        ops = bnd * 5 * w[3].shape[0]
    elif name in ("chan_data_bwd", "chan_wgt_bwd"):  # w = (g, ln2w, ln2b, bc1, wc1, wc2)
        ops = bnd * (3 if name == "chan_data_bwd" else 4) * w[4].shape[0]
    elif name.startswith("fused_resmlp_block"):
        F = w[8].shape[0]
        ops = 2 * B * N * (N * D + 2 * D * F)
    elif name.startswith("fused_gmlp_block"):
        F, Nw = w[2].shape[0] // 2, w[6].shape[1]  # W1 (2F, D), Wsp (N, N)
        ops = 2 * B * N * (D * 2 * F + Nw * F + F * D)
    else:
        raise ValueError(f"block_bound: no operation count for kernel {name!r}")
    t_ops = ops / PEAK["int8" if name.endswith("int8") else "bf16"]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _mixer_int8_floor(B, N, D, TD, CD):
    """The W8A8 Mixer block's data flow (csrc/mixer_block_int8.cu's Work):
    each pass reads what it consumes and writes what it makes once; the
    weights once."""
    M, Np, TDp, Dp = B * N, -(-N // 32) * 32, -(-TD // 32) * 32, -(-D // 32) * 32
    ck = CD // 4 if CD % 4 == 0 and CD >= 2048 else CD
    ckp, nch = -(-ck // 32) * 32, CD // ck
    nbytes = (3 * M * D * 2            # x: LN1's statistics, its quantize pass, the residual
              + 2 * 2 * M * 8          # two row_stats passes, written and read
              + 2 * (B * D * Np + B * D * 4)  # qxn, sxn written and read
              + 2 * B * TD * D * 4     # t
              + 2 * (B * D * TDp + B * D * 4)  # qt, st
              + 4 * M * D * 2          # h written, read by its statistics, LN2 and the residual
              + 2 * (M * Dp + M * 4)   # qhn, shn
              + 2 * M * CD * 4         # c
              + 2 * (M * nch * ckp + M * nch * 4)  # qc, sc
              + M * D * 2              # out
              + TD * Np + N * TDp + CD * Dp + D * nch * ckp  # int8 weights
              + 4 * (TD + N + CD + D) + 2 * (4 * D + TD + N + CD + D))  # scales, LN, biases
    return "the data flow's bytes (f32 t and c each way, x three reads, h four passes, codes)", nbytes


def _gmlp_bf16_floor(B, N, D, F):
    """The bf16 gMLP block's data flow (csrc/gmlp_block.cu's Work): each
    pass reads what it consumes and writes what it makes once; the weights
    once."""
    M, Np = B * N, -(-N // 8) * 8
    nbytes = 2 * (2 * M * D            # x: LN1 and the residual
                  + 2 * M * D          # xn written and read
                  + M * 2 * F          # y written
                  + M * F + M * F      # its v half read by LN2, its u half by the gate
                  + 2 * M * F          # vn written and read
                  + 2 * M * F          # g written and read
                  + M * D              # out
                  + 2 * N * Np + N * N  # Wsp copied into rows of Np, then read
                  + 2 * F * D + D * F + 3 * D + 2 * F + 2 * F + N)  # weights, LN, biases
    return "the data flow's bytes (y written, its halves read, vn and g each way, xn, x, out)", \
        nbytes


def _resmlp_bf16_floor(B, N, D, F):
    """The bf16 ResMLP block's data flow (csrc/resmlp_block.cu's Work): each
    pass reads what it consumes and writes what it makes once; the weights
    once."""
    M, Np = B * N, -(-N // 8) * 8
    nbytes = (M * D * 2                # x read by the affine
              + 3 * M * D * 2          # h written, read by the token product and its epilogue
              + 2 * M * D * 4          # h2 (f32) written, read by FF2's residual
              + 2 * M * D * 2          # h2b written, read by FF1
              + 2 * M * F * 2          # c written and read
              + M * D * 2              # out
              + 2 * (2 * N * Np + N * N)  # Wt copied into rows of Np, then read
              + 2 * (2 * F * D + N + F + 7 * D))  # W1, W2, biases, affines, gammas
    return "the data flow's bytes (h three passes, h2 f32 and h2b each way, c each way, x, out)", \
        nbytes


def _resmlp_int8_floor(B, N, D, F):
    """The W8A8 ResMLP block's data flow (csrc/resmlp_block_int8.cu's Work):
    each pass reads what it consumes and writes what it makes once; the
    weights once."""
    M, Np, Dp = B * N, -(-N // 32) * 32, -(-D // 32) * 32
    ck = F // 4 if F % 4 == 0 and F >= 2048 else F
    ckp, nch = -(-ck // 32) * 32, F // ck
    nbytes = (2 * M * D * 2            # x: the token quantize pass and the token epilogue
              + 2 * (B * D * Np + B * D * 4)  # qh, sh written and read
              + 3 * M * D * 4          # h2 (f32) written, read by its quantize pass and FF2's
              + 2 * (M * Dp + M * 4)   # qhb, shb
              + 2 * M * F * 4          # c (f32) written and read
              + 2 * (M * nch * ckp + M * nch * 4)  # qc, sc
              + M * D * 2              # out
              + N * Np + F * Dp + D * nch * ckp  # int8 weights
              + 4 * (N + F + D) + 2 * (N + F + 7 * D))  # scales, biases, affines, gammas
    return "the data flow's bytes (f32 h2 three passes and c each way, x twice, codes, out)", \
        nbytes


def _token_bwd_floors(B, N, D, TD, CD):
    """The token backward's data flow (csrc/mixer_block_bwd.cu), each pass
    reading what it consumes and writing what it makes once, the weights
    once: the parent design's (f32 tp written by the recompute, read and
    rewritten by the dtp product, read by dbt1's row sums) and this one's
    (tp in registers, dbt1's partials of eight columns written and read).
    E: bytes of a (B, N, D) bf16 tensor; F: of a (B, TD, D) one."""
    E, F = 2 * B * N * D, 2 * B * TD * D
    shared = (3 * E                    # x: LN1, the LN backward's rows and columns
              + 3 * E                  # xn written, read by two products
              + 3 * E                  # dh read by two products and the LN backward
              + 2 * F                  # t written and read
              + 3 * F                  # dtp written, read by dWt1 and dxn
              + 6 * E                  # dxn (f32) written and read twice
              + E                      # dx
              + 2 * 2 * TD * N + 4 * (2 * TD * N + TD + 2 * D))  # weights, gradients
    parent = shared + 2 * F * 4        # f32 tp: written, read and rewritten, read
    return [("the parent design's data flow (f32 tp four passes)", parent),
            ("this design's data flow (tp in registers, dbt1 partials)", shared + F // 2)]


def _chan_data_floors(B, N, D, TD, CD):
    """The channel data backward's data flow, as _token_bwd_floors counts
    it: the parent design's (f32 cp written by its recompute product and
    read by the dc product, bf16 dcp written and read) and this one's (cp
    and dc in registers, dcp written and read). E: bytes of a (B, N, D)
    bf16 tensor; G: of a (B·N, CD) one."""
    E, G = 2 * B * N * D, 2 * B * N * CD
    shared = (3 * E                    # h: LN2, the LN backward's rows and columns
              + 2 * E                  # hn written and read
              + 2 * E                  # g read by a product and the LN backward
              + 2 * G                  # dcp written and read
              + 6 * E                  # dhn (f32) written and read twice
              + E                      # dh
              + 2 * 3 * CD * D + 8 * D)  # Wc1, Wc2 and its copy, LN gradients
    return [("the parent design's data flow (f32 cp written and read)", shared + 4 * G),
            ("this design's data flow (cp and dc in registers)", shared)]


# the data flow's bytes of a block kernel at b256, where they bound it
# beyond its operations (rows 6 and 7: before and after their redesign)
FLOORS = {
    "token_bwd": _token_bwd_floors,
    "chan_data_bwd": _chan_data_floors,
    # the f32 intermediates this data flow moves: y (B·N, 2F) written, its v
    # half read twice and its u half once, g (B·N, F) written and read
    "fused_gmlp_block_int8": lambda B, N, D, F: ("the f32 intermediates' bytes",
                                                 7 * B * N * F * 4),
    "fused_mixer_block_int8": _mixer_int8_floor,
    "fused_gmlp_block": _gmlp_bf16_floor,
    "fused_resmlp_block": _resmlp_bf16_floor,
    "fused_resmlp_block_int8": _resmlp_int8_floor,
}


def phase_timing(jt, table, name):
    from jittor_mlp_tpu_torch import config

    timings = {}
    for kname, (mod, fn, ref, inputs, shapes, *_rest) in table.items():
        shape = (256, *shapes[0][1:])
        x, w = inputs(*shape, seed=7)
        outs = outputs(getattr(mod, fn)(x, *w))
        ms = cuda_ms(lambda: getattr(mod, fn)(x, *w), 10)
        plain_ms = cuda_ms(lambda: getattr(mod, ref)(x, *w), 5)
        bound_ms, bound_by = block_bound(kname, x, w, outs)
        print(f"[5] {kname} b256 {shape}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})  [{name}]", flush=True)
        floors = FLOORS[kname](*shape) if kname in FLOORS else []
        for what, floor in floors if isinstance(floors, list) else [floors]:
            print(f"[5] {kname} b256: {what} {floor / 1e9:.4f} GB, "
                  f"{floor / HBM_BYTES_S * 1e3:.4f} ms at the HBM rate (the data flow's floor)  "
                  f"[{name}]", flush=True)
        timings[kname] = (ms, plain_ms, bound_ms, bound_by)
        del x, w, outs
        torch.cuda.empty_cache()

    xb = torch.randn(256, 3, 224, 224, device="cuda").bfloat16()

    def forwards(tag, variants):
        times = {k: [] for k in variants}
        order = list(variants) + list(variants)[::-1]
        with torch.inference_mode():
            for which in order:
                model, int8 = variants[which]
                with config.int8_mode() if int8 else contextlib.nullcontext():
                    times[which].append(cuda_ms(lambda: model.forward(xb), 5))
        for which, runs in times.items():
            ms = sum(runs) / len(runs)
            print(f"[5] {tag} forward b256, {which}: {ms:.4f} ms, {256e3 / ms:.1f} img/s "
                  f"(runs {runs})  [{name}]", flush=True)

    kernel = jt.MLPMixerForImageClassification(**MIXER_B16).to_bf16().eval()
    plain = jt.MLPMixerForImageClassification(**MIXER_B16, use_pallas=False).to_bf16().eval()
    forwards("Mixer-B/16", {"bf16 plain path": (plain, False),
                            "bf16 kernel path": (kernel, False),
                            "int8 kernel path": (kernel, True)})
    del kernel, plain
    torch.cuda.empty_cache()
    res = jt.ResMLPForImageClassification(**RESMLP_S24).to_bf16().eval()
    forwards("ResMLP-S24", {"bf16 kernel path": (res, False),
                            "int8 kernel path": (res, True)})
    del res
    torch.cuda.empty_cache()
    gmlp = jt.gMLPForImageClassification(**GMLP_S).to_bf16().eval()
    g_plain = jt.gMLPForImageClassification(**GMLP_S, use_pallas=False).to_bf16().eval()
    forwards("gMLP-S", {"bf16 plain path": (g_plain, False),
                        "bf16 kernel path": (gmlp, False),
                        "int8 kernel path": (gmlp, True)})
    del gmlp, g_plain
    torch.cuda.empty_cache()
    as_mlp = jt.AS_MLP(**AS_MLP_T).to_bf16().eval()
    a_plain = jt.AS_MLP(**AS_MLP_T, use_pallas=False).to_bf16().eval()
    forwards("AS-MLP-T", {"bf16 plain path": (a_plain, False),
                          "bf16 kernel path": (as_mlp, False),
                          "int8 kernel path": (as_mlp, True)})
    return timings


def shift_timing(mod, name):
    """The shift at AS-MLP-T's stage-1 shape at b256 in bf16, each axis,
    kernel and twin, against its bound: a copy moves each element in and
    out once. Returns (ms, twin ms, bound ms, "bytes"), the ms the mean of
    the two axes, as the model launches both equally."""
    x = shift_input((256, 56, 56, 96), torch.bfloat16, seed=7)
    bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
    ms, plain_ms = [], []
    for axis in (1, 2):
        ms.append(cuda_ms(lambda: mod.shift(x, 5, axis), 20))
        plain_ms.append(cuda_ms(lambda: mod.axial_shift_ref(x, 5, axis), 5))
        print(f"[5] axial_shift b256 {tuple(x.shape)} axis {axis}: kernel {ms[-1]:.4f} ms, twin "
              f"{plain_ms[-1]:.4f} ms, bound {bound_ms:.4f} ms (bytes)  [{name}]", flush=True)
    print("[5] axial_shift: no single PyTorch call computes the zero-fill grouped shift "
          "(torch.roll wraps around): library_ms null", flush=True)
    return sum(ms) / 2, sum(plain_ms) / 2, bound_ms, "bytes"


def gemm_timing(mod, name):
    """Phase 5 for the GEMM core at b256's two channel products (GEMM_TIMED,
    the GELU and the residual epilogue): gemm_tn on the wgmma core and on the
    WMMA core and cuBLAS's bf16 torch.matmul (the product alone, without the
    epilogue: the yardstick, which the port never calls), in turns, then the
    twin; ms, TFLOP/s and share of the dense bf16 peak. Returns (wgmma ms,
    twin ms, bound ms, bound_by, cuBLAS ms), each summed over the two
    products: one block's channel half."""
    total = dict.fromkeys(("sm90", "wmma", "cublas", "twin", "bound"), 0.0)
    total_by = set()
    for (M, N, K), residual in zip(GEMM_TIMED, (False, True)):
        a, b, bias, kw = gemm_inputs(M, N, K, residual, seed=7)
        out = mod.gemm_tn(a, b, bias, **kw)
        flop = 2 * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, bias, out, *kw.values())
                     if torch.is_tensor(t))
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        bound, bound_by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
        fns = {"sm90": lambda: mod.gemm_tn(a, b, bias, core="sm90", **kw),
               "wmma": lambda: mod.gemm_tn(a, b, bias, core="legacy", **kw),
               "cublas": lambda: torch.matmul(a, b.t())}
        runs = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            runs[k].append(cuda_ms(fns[k], 20))
        epi = "residual" if residual else "gelu_tanh"
        for k, r in runs.items():
            ms = sum(r) / len(r)
            total[k] += ms
            what = "torch.matmul (cuBLAS, no epilogue)" if k == "cublas" else f"{k} core"
            rate = flop / ms / 1e9  # TFLOP/s
            print(f"[5] gemm_tn b256 {(M, N, K)} {epi}, {what}: {ms:.4f} ms, {rate:.1f} TFLOP/s, "
                  f"{100 * rate * 1e12 / PEAK['bf16']:.1f}% of the bf16 peak (runs {r})  [{name}]",
                  flush=True)
        twin = cuda_ms(lambda: mod.gemm_tn_ref(a, b, bias, **kw), 3)
        total["twin"] += twin
        total["bound"] += bound
        print(f"[5] gemm_tn b256 {(M, N, K)} {epi}: twin {twin:.4f} ms, bound {bound:.4f} ms "
              f"({bound_by})  [{name}]", flush=True)
        total_by.add(bound_by)
        del a, b, bias, kw, out
        torch.cuda.empty_cache()
    print(f"[5] gemm_tn b256, one block's two channel products: wgmma core {total['sm90']:.4f} ms, "
          f"WMMA core {total['wmma']:.4f} ms, cuBLAS {total['cublas']:.4f} ms, bound "
          f"{total['bound']:.4f} ms  [{name}]", flush=True)
    by = total_by.pop() if len(total_by) == 1 else "operations"  # both are, at these shapes
    return (total["sm90"], total["twin"], total["bound"], by), total["cublas"]


def _timed_turns(fns, iters):
    """{name: mean ms} of each fn, in turns (each name, then in reverse)."""
    runs = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        runs[k].append(cuda_ms(fns[k], iters))
    return {k: sum(r) / len(r) for k, r in runs.items()}, runs


def _s8_timing(mod, name, cases, what):
    """Phase 5 for a block's int8 products at b256 (cases as CORE_S8's) on
    the s8 wgmma core, on mma.sync and as torch._int_mm on the same codes
    (the product alone, no scales and no chunks: the yardstick, which the
    port never calls; a token product, the weight shared and the codes an
    entry an image, as one (entries·N, K) × (K, M) call, the weight's rows
    zero-padded to a multiple of 8, as _int_mm needs), in turns; then each
    twin. Returns ((ms, twin ms, bound ms, bound_by), library ms), each
    summed over the products."""
    total = dict.fromkeys(("sm90", "old", "lib", "twin", "bound", "ops_ms", "bytes_ms"), 0.0)
    for nz, M, N, K, ab, bb, chunk in cases:
        a, b, rs, cs = s8_core_inputs(nz, M, N, K, ab, bb, chunk, seed=7)
        out = mod.gemm_s8(a, b, rs, cs, chunk=chunk)
        ops = 2 * nz * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, rs, cs, out))
        if bb and not ab:  # a token product: (entries·N, K) codes times the weight padded
            aa = b.reshape(nz * N, K)
            bpad = torch.zeros((-(-M // 8) * 8, K), dtype=torch.int8, device="cuda")
            bpad[:M] = a

            def lib():
                return torch._int_mm(aa, bpad.t())
        else:
            def lib():
                return torch._int_mm(a, b.t())
        ms, runs = _timed_turns({"sm90": lambda: mod.gemm_s8(a, b, rs, cs, chunk=chunk),
                                 "old": lambda: mod.gemm_s8(a, b, rs, cs, chunk=chunk,
                                                            core="legacy"),
                                 "lib": lib}, 20)
        twin = cuda_ms(lambda: mod.gemm_s8_ref(a, b, rs, cs, chunk=chunk), 3)
        t_ops, t_bytes = ops / PEAK["int8"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_s8 b256 {nz} x (M, N, K) {(M, N, K)} chunk={chunk}: s8 wgmma core "
              f"{ms['sm90']:.4f} ms ({ops / ms['sm90'] / 1e9:.1f} TOP/s), mma.sync core "
              f"{ms['old']:.4f} ms ({ops / ms['old'] / 1e9:.1f}), torch._int_mm (no scales) "
              f"{ms['lib']:.4f} ms ({ops / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (operations {t_ops * 1e3:.4f}, bytes "
              f"{t_bytes * 1e3:.4f}) (runs {json.dumps(runs)})  [{name}]", flush=True)
        del a, b, rs, cs, out
        torch.cuda.empty_cache()
    print(f"[5] gemm_s8 b256, {what}: s8 wgmma core {total['sm90']:.4f} ms, mma.sync core "
          f"{total['old']:.4f} ms, torch._int_mm {total['lib']:.4f} ms, bound "
          f"{total['bound']:.4f} ms  [{name}]", flush=True)
    return ((total["sm90"], total["twin"], total["bound"],
             "operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes"), total["lib"])


def _bf16_timing(mod, name, cases, what):
    """Phase 5 for bf16 products at b256 (cases as (entries, M, N, K, a,
    b, keywords) with their operands) on the wgmma core, the WMMA core and
    torch.matmul on the same operands (the product alone, without the
    epilogue: the yardstick), in turns; then each twin. Returns ((ms, twin
    ms, bound ms, bound_by), library ms), each summed over the products."""
    total = dict.fromkeys(("sm90", "old", "lib", "twin", "bound", "ops_ms", "bytes_ms"), 0.0)
    for tag, a, b, kw in cases:
        out = mod.gemm_bf16(a, b, **kw)
        nz, M, N = out.shape
        K = a.shape[-2] if kw.get("a_mn") else a.shape[-1]
        flop = 2 * (nz if kw.get("slab") is None else 1) * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, out))
        at = a.transpose(-1, -2) if kw.get("a_mn") else a
        bt = b if kw.get("b_mn") else b.transpose(-1, -2)
        ms, runs = _timed_turns({"sm90": lambda: mod.gemm_bf16(a, b, **kw),
                                 "old": lambda: mod.gemm_bf16(a, b, core="legacy", **kw),
                                 "lib": lambda: torch.matmul(at, bt)}, 20)
        twin = cuda_ms(lambda: mod.gemm_bf16_ref(a, b, **kw), 3)
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_bf16 b256 {tag}: wgmma core {ms['sm90']:.4f} ms "
              f"({flop / ms['sm90'] / 1e9:.1f} TFLOP/s, "
              f"{100 * flop / ms['sm90'] / 1e9 * 1e12 / PEAK['bf16']:.1f}% of the bf16 peak), "
              f"WMMA core {ms['old']:.4f} ms ({flop / ms['old'] / 1e9:.1f}), torch.matmul "
              f"{ms['lib']:.4f} ms ({flop / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (runs {json.dumps(runs)})  [{name}]",
              flush=True)
        del out, at, bt
        torch.cuda.empty_cache()
    print(f"[5] gemm_bf16 b256, {what}: wgmma core {total['sm90']:.4f} ms, WMMA core "
          f"{total['old']:.4f} ms, torch.matmul {total['lib']:.4f} ms, bound "
          f"{total['bound']:.4f} ms  [{name}]", flush=True)
    return ((total["sm90"], total["twin"], total["bound"],
             "operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes"), total["lib"])


def mode_timing(mod, bwd, name):
    """Phase 5 for the core's dual and Group modes at b256: DUAL_TIMED (the
    channel data and token backwards' pairs) on the wgmma core, the WMMA
    core (two products, v1 through f32) and torch.matmul twice (the pair
    alone, no epilogue: the yardstick, which the port never calls);
    GROUP_TIMED (dWt2, dWt1 in the token backward's groups) on the wgmma
    core, the WMMA core's gemm_sum and torch.einsum over the images (one
    sum, no partials); in turns, then each twin; then the library's time of
    all the products of rows 6 and 7 (the pairs, the sums, dxn and dhn).
    Returns {row: ((ms, twin ms, bound ms, bound_by), library ms)}, each
    summed over the products."""
    rows, dual_lib = {}, []
    total = dict.fromkeys(("sm90", "old", "lib", "twin", "bound", "ops_ms", "bytes_ms"), 0.0)
    for case in DUAL_TIMED:
        nz, M, N, K, lda, a_mn, b_mn, ab, bb = case
        a1, b1, a2, b2 = dual_core_inputs(*case, seed=7)
        kw = dict(a_mn=a_mn, b_mn=b_mn)
        out = mod.gemm_bf16_dual(a1, b1, a2, b2, **kw)
        flop = 2 * 2 * nz * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a1, b1, a2, b2, *out))
        at1, at2 = (t.transpose(-1, -2) if a_mn else t for t in (a1, a2))
        bt1, bt2 = (t if b_mn else t.transpose(-1, -2) for t in (b1, b2))
        ms, runs = _timed_turns({
            "sm90": lambda: mod.gemm_bf16_dual(a1, b1, a2, b2, **kw),
            "old": lambda: mod.gemm_bf16_dual(a1, b1, a2, b2, core="legacy", **kw),
            "lib": lambda: (torch.matmul(at1, bt1), torch.matmul(at2, bt2))}, 10)
        dual_lib.append(runs["lib"])
        twin = cuda_ms(lambda: mod.gemm_bf16_dual_ref(a1, b1, a2, b2, **kw), 2)
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_bf16_dual b256 {nz} x (M, N, K) {(M, N, K)} b_mn={b_mn}: wgmma core "
              f"{ms['sm90']:.4f} ms ({flop / ms['sm90'] / 1e9:.1f} TFLOP/s), WMMA core "
              f"{ms['old']:.4f} ms ({flop / ms['old'] / 1e9:.1f}), torch.matmul x 2 "
              f"{ms['lib']:.4f} ms ({flop / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (operations {t_ops * 1e3:.4f}, bytes "
              f"{t_bytes * 1e3:.4f}) (runs {json.dumps(runs)})  [{name}]", flush=True)
        del a1, b1, a2, b2, out, at1, at2, bt1, bt2
        torch.cuda.empty_cache()
    rows["gemm_bf16_dual_sm90"] = ((total["sm90"], total["twin"], total["bound"],
                                    "operations" if total["ops_ms"] >= total["bytes_ms"]
                                    else "bytes"), total["lib"])
    total = dict.fromkeys(total, 0.0)
    for images, M, N, K, _ in GROUP_TIMED:
        per = token_group(bwd, images, M, N, K)
        a, b = group_inputs(images, M, N, K, seed=7)
        out = mod.gemm_bf16_group(a, b, per)
        flop = 2 * images * M * N * K
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, out))
        ms, runs = _timed_turns({
            "sm90": lambda: mod.gemm_bf16_group(a, b, per),
            "old": lambda: mod.gemm_bf16_group(a, b, per, core="legacy"),
            "lib": lambda: torch.einsum("bmk,bnk->mn", a, b)}, 20)
        twin = cuda_ms(lambda: mod.gemm_bf16_group_ref(a, b, per), 2)
        t_ops, t_bytes = flop / PEAK["bf16"], nbytes / HBM_BYTES_S
        for k in ms:
            total[k] += ms[k]
        total["twin"] += twin
        total["bound"] += max(t_ops, t_bytes) * 1e3
        total["ops_ms"] += t_ops * 1e3
        total["bytes_ms"] += t_bytes * 1e3
        print(f"[5] gemm_bf16_group b256 {images} images (M, N, K) {(M, N, K)} in "
              f"{out.shape[0]} partials of {per}: wgmma core {ms['sm90']:.4f} ms "
              f"({flop / ms['sm90'] / 1e9:.1f} TFLOP/s), WMMA core {ms['old']:.4f} ms "
              f"({flop / ms['old'] / 1e9:.1f}), torch.einsum {ms['lib']:.4f} ms "
              f"({flop / ms['lib'] / 1e9:.1f}); twin {twin:.4f} ms; bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms (runs {json.dumps(runs)})  [{name}]",
              flush=True)
        del a, b, out
        torch.cuda.empty_cache()
    group_lib = total["lib"]
    rows["gemm_bf16_group_sm90"] = ((total["sm90"], total["twin"], total["bound"],
                                     "operations" if total["ops_ms"] >= total["bytes_ms"]
                                     else "bytes"), total["lib"])
    # the products of rows 6 and 7 beside these, in the library alone: dxn =
    # Wt1ᵀ·dtp an image and dhn = dcp·Wc1 (torch.matmul, f32 out not asked)
    rn, _ = _draw(9)
    wt1, dtp = rn(384, 196), rn(256, 384, 768)
    dcp, wc1 = rn(256 * 196, 3072), rn(3072, 768)
    other, _ = _timed_turns({"dxn": lambda: torch.matmul(wt1.t(), dtp),
                             "dhn": lambda: torch.matmul(dcp, wc1)}, 20)
    dual = [sum(r) / len(r) for r in dual_lib]
    token = dual[1] + group_lib + other["dxn"]
    chan = dual[0] + other["dhn"]
    print(f"[5] the products of rows 6 and 7 at b256 in the library alone (torch.matmul, "
          f"torch.einsum; no epilogue): token_bwd {token:.4f} ms (the dual pair "
          f"{dual[1]:.4f}, dWt2 + dWt1 {group_lib:.4f}, dxn {other['dxn']:.4f}); chan_data_bwd "
          f"{chan:.4f} ms (the dual pair {dual[0]:.4f}, dhn {other['dhn']:.4f})  [{name}]",
          flush=True)
    del wt1, dtp, dcp, wc1
    torch.cuda.empty_cache()
    return rows


def core_timing(mod, name):
    """Phase 5 for the core's modes at b256, by block: gMLP-S's three int8
    products (CORE_S8_TIMED) and the W8A8 Mixer-B/16 block's four
    (MIXER_S8_TIMED, the second chunked) on the s8 wgmma core, on mma.sync
    and as torch._int_mm; gMLP-S's three bf16 products (GMLP_BF16_TIMED) and
    Mixer-B/16's four channel backward products (CORE_BF16_TIMED) on the
    wgmma core, the WMMA core and torch.matmul; in turns, then each twin.
    Returns {row: ((ms, twin ms, bound ms, bound_by), library ms)}."""
    rows = {"gemm_s8_sm90": _s8_timing(mod, name, CORE_S8_TIMED, "gMLP-S's three products")}
    # The token product's 196 tokens take two 192-row tiles, the second
    # nearly all zero fill: the same product on the first 192 tokens alone
    # shows what that second tile costs, the most that a layout without it
    # (the transposed product with an N tile over the tokens) could save.
    cut = {}
    for M in (196, 192):
        a, b, rs, cs = s8_core_inputs(256, M, 1536, 224, False, True, None, seed=8)
        cut[M] = cuda_ms(lambda: mod.gemm_s8(a, b, rs, cs), 20)
        del a, b, rs, cs
    print(f"[5] gemm_s8 b256 token product, 256 x (M, 1536, 224): M = 196 tokens (two row "
          f"tiles) {cut[196]:.4f} ms, M = 192 (one) {cut[192]:.4f} ms: the ragged tile costs "
          f"{cut[196] - cut[192]:.4f} ms  [{name}]", flush=True)
    rows["gemm_s8_mixer_sm90"] = _s8_timing(mod, name, MIXER_S8_TIMED,
                                            "the W8A8 Mixer-B/16 block's four products")
    gmlp = []
    for nz, M, N, K, lda, b_mn in GMLP_BF16_TIMED:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=7)
        gmlp.append((f"{nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn}", a, b,
                     {"b_mn": b_mn}))
    rows["gemm_bf16_gmlp_sm90"] = _bf16_timing(mod, name, gmlp,
                                               "gMLP-S's three bf16 products")
    del gmlp
    rows["gemm_s8_resmlp_sm90"] = _s8_timing(mod, name, RES_S8_TIMED,
                                             "ResMLP-S24's three int8 products")
    res = []
    for nz, M, N, K, lda, b_mn in RES_BF16_TIMED:
        a, b = gmlp_core_inputs(nz, M, N, K, lda, b_mn, seed=7)
        res.append((f"{nz} x (M, N, K) {(M, N, K)} A rows of {lda} b_mn={b_mn}", a, b,
                    {"b_mn": b_mn}))
    rows["gemm_bf16_resmlp_sm90"] = _bf16_timing(mod, name, res,
                                                 "ResMLP-S24's three bf16 products")
    del res
    bwd = []
    for M, N, K, a_mn, b_mn, slab in CORE_BF16_TIMED:
        a, b = bf16_core_inputs(M, N, K, a_mn, b_mn, seed=7)
        bwd.append((f"(M, N, K) {(M, N, K)} a_mn={a_mn} b_mn={b_mn} slab={slab}", a, b,
                    dict(a_mn=a_mn, b_mn=b_mn, slab=slab)))
    rows["gemm_bwd_sm90"] = _bf16_timing(mod, name, bwd,
                                         "Mixer-B/16's four channel backward products")
    return rows


def lab_timing(mod, name):
    """Phase 5 for the kernel lab's kernels at b256, the block's full shape,
    bf16: each kernel and its twin at its first variant (the ablate kernel
    at every mode; its row takes LAB_TIMED), against the bound. Returns
    name → (ms, twin ms, bound ms, bound_by)."""
    timings = {}
    x, w = block_inputs(256, 196, 768, 384, 3072, seed=7)
    for fn in LAB_KERNELS:
        variants = lab_variants(fn)
        for vname, kw in variants.items():
            if fn != "ablate_block" and vname != next(iter(variants)):
                continue
            xin = mod.to_tokmajor(x, kw["bt"]) if fn == "tokmajor_block" else x
            kern, twin = getattr(mod, fn), getattr(mod, f"{fn}_ref")
            out = kern(xin, *w, **kw)
            ms = cuda_ms(lambda: kern(xin, *w, **kw), 10)
            plain_ms = cuda_ms(lambda: twin(xin, *w, **kw), 5)
            bound_ms, bound_by = block_bound(fn, xin, w, (out,))
            print(f"[5] {fn} ({vname}) b256 {tuple(xin.shape)}: kernel {ms:.4f} ms, twin "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{name}]", flush=True)
            if fn != "ablate_block" or vname == LAB_TIMED:
                timings[fn] = (ms, plain_ms, bound_ms, bound_by)
            del out, xin
            torch.cuda.empty_cache()
    return timings


def phase_lab_stack(mods, name):
    """Phase 7: the port's kernel lab through its own functions, its check
    at b8 against kernel 1, then every variant of its table over the
    12-block stack at b256. Every count is set to 0 just before the stack
    runs and read just after: each lab kernel launches 12 times a pass of
    each of its variants, warm-up included. Returns the lab kernels'
    launches."""
    from jittor_mlp_tpu_torch.tools import kernel_lab as lab

    kl, mb = mods["kernel_lab"], mods["mixer_block"]
    weights = lab.make_weights(0, "cuda")
    print("[7] kernel lab check at b8 against kernel 1:", flush=True)
    lab.check(weights, lab.make_input(1, 8, "cuda"))
    names = list(lab.variants())
    print(f"[7] kernel lab stack: {len(names)} variants, b256, {lab.DEPTH} blocks, 1 warm-up + "
          f"{LAB_ITERS} timed passes each  [{name}]", flush=True)
    reset_counts(mods)  # the lab's run starts here
    routes0 = {"lab": kl.routes(), "kernel 1": mb.routes()}
    stats = lab.bench(names, weights, 256, LAB_ITERS, name)
    torch.cuda.synchronize()
    counts = dict(kl.LAUNCHES)
    counts["fused_mixer_block"] = mb.LAUNCHES
    want = dict.fromkeys(counts, 0)
    for v, st in stats.items():  # plain launches no kernel; a SAME_AS variant none of its own
        fn = lab.VARIANTS[v][0]
        if fn is not None and "same_as" not in st:
            want[fn] += lab.DEPTH * st["passes"]
    print(f"[7] launches in the lab's run: {json.dumps(counts)} (want {json.dumps(want)})",
          flush=True)
    check(counts == want, f"kernel lab launches {counts}, want {want}")
    check_routes("[7] the lab's kernels", routes0["lab"], kl.routes(),
                 2 * sum(counts[fn] for fn in LAB_KERNELS))
    check_routes("[7] kernel 1 in the lab", routes0["kernel 1"], mb.routes(),
                 2 * counts["fused_mixer_block"])
    ref = stats["prod2"]["img_s"]
    print("[7] variant, img/s, stack TFLOP/s, ratio to prod2:", flush=True)
    for v, st in stats.items():
        same = f" (= {st['same_as']})" if "same_as" in st else ""
        print(f"[7]   {v:12s} {st['img_s']:10.1f} {st['tflops']:8.2f} {st['img_s'] / ref:7.4f}"
              f"{same}  [{name}]", flush=True)
    return {fn: counts[fn] for fn in LAB_KERNELS}


def mean_gate(tokens):
    """A state-dict edit for the split-attention families: each
    ``split_attention.mlp1`` weight divided by the tokens its gate sums
    over (``tokens(key)``), so that the gate reads their mean. At the
    seed's draw the gate's logits grow with the sum over 256 or 1,024
    tokens and its softmax over the three branches is one-hot: bf16 or
    int8 rounding flips it (S2-MLPv2: bf16 0.33 of max|logit| from f32,
    70% top-1, on an H100), and a wrong branch with no weight would go
    unseen."""
    def edit(sd):
        for k in sd:
            if k.endswith("split_attention.mlp1.weight"):
                sd[k] = sd[k] / tokens(k)
    return edit


def layer_scale(value):
    """A state-dict edit for MS-MLP: every block's ``gamma`` layer scale
    set to ``value``. The factory's 1e-6 makes each block add next to
    nothing, so neither the bf16 band nor the blocks-move check would see
    a wrong block."""
    def edit(sd):
        for k in sd:
            if k.endswith(".gamma"):
                sd[k] = torch.full_like(sd[k], value)
    return edit


# Phase 8: the families ported without a kernel of their own, at the full
# widths of compare.py's CONFIGS: (title, factory (a name in the package,
# dotted where it is reached through models, as compare.py reaches
# ActivexTiny), arguments, the modules whose weights zeroed make every block
# the identity: each residual branch's last layer, an edit of the seed-0
# state dict or None)
FAMILIES = {
    "vip": ("ViP (patch 14, d_model 256, depth 30, segments 16)", "ViP",
            dict(image_size=224, patch_size=14, d_model=256, depth=30, segments=16,
                 weighted=True),
            lambda m: [layer for blk in m.blocks.model for layer in (blk[0].fn[1], blk[1].fn[3])],
            mean_gate(lambda k: 16 * 16)),
    "s2_mlp_v1": ("S2-MLP-wide (patch 16, d_model 768, depth 12)", "S2MLPv1_wide", {},
                  lambda m: [blk[k].fn[3] for st in m.stages for blk in st[1].model
                             for k in (0, 1)], None),
    "s2_mlp_v2": ("S2-MLPv2 (patches [7, 2], d_model [192, 384], depths [4, 14])", "S2MLPv2",
                  dict(image_size=224, patch_size=[7, 2], d_model=[192, 384], depth=[4, 14],
                       expansion_factor=[3, 3]),
                  lambda m: [layer for st in m.stages for blk in st[1].model
                             for layer in (blk[0].fn.mlp2, blk[1].fn[3])],
                  mean_gate(lambda k: 32 * 32 if k.startswith("stages.0.") else 16 * 16)),
    "raft_mlp": ("RaftMLP (dims 64 and 128, patches 4 and 2, raft 2, depths 2)", "RaftMLP",
                 dict(layers=[{"depth": 2, "dim": 64, "patch_size": 4, "raft_size": 2},
                              {"depth": 2, "dim": 128, "patch_size": 2, "raft_size": 2}]),
                 lambda m: [blk[k].fn[3] for level in m.levels for blk in level.fn[2:]
                            for k in (1, 3, 5)], None),
    "swin_mlp": ("Swin-MLP-T (embed 96, depths [2, 2, 6, 2], window 7)", "SwinMLP",
                 dict(drop_path_rate=0.0),
                 lambda m: [layer for st in m.layers for blk in st.blocks
                            for layer in (blk.spatial_mlp, blk.mlp.fc2)], None),
    "dyna_mlp": ("DynaMixer-T", "DynaMixer", dict(model_name="T"),
                 lambda m: [layer for st in m.stages for blk in st[1].layers
                            for layer in (blk[0].fn.proj_o, blk[1].fn.net[3])], None),
    "ms_mlp": ("MS-MLP-T (embed 96, depths [2, 2, 6, 2], shift 5)", "MS_MLP",
               dict(drop_path_rate=0.0),
               lambda m: [blk.pwconv2 for layer in m.layers for blk in layer.blocks],
               layer_scale(0.5)),
    "hire_mlp": ("Hire-MLP-Tiny (d_model [64, 128, 320, 512], depths [4, 6, 24, 3])",
                 "HireMLP", {},
                 lambda m: [layer for st in m.layers for blk in st.model
                            for layer in (blk[0].fn[0].proj_c, blk[0].fn[0].proj_h.net[2],
                                          blk[0].fn[0].proj_w.net[2], blk[1].fn[3])], None),
    "cycle_mlp": ("CycleMLP-B2 (layers [2, 3, 10, 3], dims [64, 128, 320, 512])",
                  "CycleMLP_B2", {},
                  lambda m: [layer for slot in m.network if isinstance(slot, torch.nn.ModuleList)
                             for blk in slot for layer in (blk.attn.proj, blk.mlp.fc2)], None),
    "active_mlp": ("ActiveMLP-xT (depths [2, 2, 4, 2], share [2, 4, 4, 8], intv 2)",
                   "models.active_mlp.ActivexTiny", {},
                   lambda m: [layer for st in m.blocks for blk in st
                              for layer in (blk.atm.proj, blk.mlp.fc2)], None),
}
# f32 logits on the card (TF32 off) against the CPU on the same weights:
# two libraries' summation orders through up to 30 blocks
CARD_VS_CPU = 1e-3  # of max|logit|
FAMILY_ITERS = 5  # timed b256 forwards, after two warm-up ones


def batched_equals_alone(tag, p, imgs):
    """p.predict on 16 images at once against each image alone: the same
    labels, top-k probabilities within 1e-3."""
    labels, probs = p.predict(imgs)
    for i in range(len(imgs)):
        li, pi = p.predict(imgs[i:i + 1])
        check(np.array_equal(li[0], labels[i]), f"{tag} image {i}: batched labels differ")
        check(np.abs(pi[0] - probs[i]).max() <= 1e-3, f"{tag} image {i}: batched probs differ")
    return labels


def family_phase(jt, key, name, x64, imgs):
    """One family at full width: f32 on the card against the CPU at b2; bf16
    and int8 against card f32 on 64 images; the blocks move the logits;
    Predictor (bf16 and weights="int8") batched == alone; b256 img/s and
    peak memory in bf16 and int8. Returns {"bf16": img/s, "int8": img/s}."""
    from jittor_mlp_tpu_torch import config

    title, factory_name, kw, branch_ends, edit = FAMILIES[key]
    factory = jt
    for part in factory_name.split("."):
        factory = getattr(factory, part)
    tag = f"[8] {title}"
    sd = factory(**kw, device="cpu").export_torch_state_dict()  # seed 0
    if edit is not None:
        edit(sd)

    def build(**where):
        return factory(**kw, **where).load_torch_state_dict(sd)

    f32 = build().eval()  # the factory builds on the card
    check(f32.device.type == "cuda" and f32.name == key, f"{tag}: {f32.device}, {f32.name}")
    cpu = build(device="cpu").eval()
    with torch.inference_mode(), config.parity_mode():
        lc = f32.forward(x64[:2])
        lcpu = cpu.forward(x64[:2].cpu())
    dev = rel_dev(lc.cpu(), lcpu)
    print(f"{tag}: {f32.param_count():,} parameters; f32 card (TF32 off) vs CPU at b2: "
          f"max|dlogit|/max|logit|={dev:.6g} (limit {CARD_VS_CPU})", flush=True)
    check(lc.shape == (2, 1000) and dev <= CARD_VS_CPU, f"{tag}: card vs CPU {dev}")
    del cpu
    model = build().to_bf16().eval()
    with torch.inference_mode():
        with config.parity_mode():
            lf = f32.forward(x64).float()
        lb = model.forward(x64.bfloat16()).float()
        with config.int8_mode():
            lq = model.forward(x64.bfloat16()).float()
    check(bool(torch.isfinite(lb).all() and torch.isfinite(lq).all()), f"{tag}: non-finite")
    compare_logits(f"{title} bf16 vs f32 (TF32 off)", lb, lf, 5e-2, 0.9, phase="8")
    # int8: the 0.1 band only. Random-init logits over 1,000 classes have near
    # ties: RaftMLP's int8 top-1 agreement read 0.8906 at 0.027 of max|logit|
    # on an H100, its classifier's 100,352-wide rows quantized per row
    compare_logits(f"{title} int8 vs f32 (TF32 off)", lq, lf, 0.1, None, phase="8")
    del f32

    p16 = jt.Predictor(model, batch_size=32)
    l16 = batched_equals_alone(f"{tag} bf16 Predictor", p16, imgs)
    pw = jt.Predictor(build(), batch_size=32, weights="int8")
    lw = batched_equals_alone(f"{tag} weights=int8 Predictor", pw, imgs)
    check(p16.dtype == pw.dtype == "bf16", f"{tag}: Predictor dtypes {p16.dtype}, {pw.dtype}")
    print(f"{tag}: bf16 and weights=int8 Predictors, 16 images batched == alone; top-1 "
          f"agreement of the two {float((lw[:, 0] == l16[:, 0]).mean()):.4f}", flush=True)
    del pw

    x = images(256, 3).bfloat16()
    rates = {}
    for mode in ("bf16", "int8"):
        ctx = config.int8_mode if mode == "int8" else contextlib.nullcontext
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def fwd():
            with torch.inference_mode(), ctx():
                model.forward(x)

        ms = cuda_ms(fwd, FAMILY_ITERS)
        rates[mode] = 256e3 / ms
        print(f"{tag} {mode} b256 forward: {ms:.4f} ms, {rates[mode]:.1f} img/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{name}]", flush=True)

    with torch.no_grad():  # every residual branch's last layer zeroed: identity blocks
        for layer in branch_ends(model):
            layer.weight.zero_()
            layer.bias.zero_()
    with torch.inference_mode():
        lz = model.forward(x64.bfloat16()).float()
    moved, bdev = rel_dev(lb, lz), rel_dev(lb, lf)
    print(f"{tag}: blocks move the logits: max|d|/max|logit| vs identity blocks {moved:.6g}, "
          f"bf16 vs f32 {bdev:.6g} (need >= 10x)", flush=True)
    check(moved >= 10 * bdev, f"{tag}: the blocks hardly move the logits: {moved} vs {bdev}")
    return rates


def phase_families(jt, mods, name):
    """Phase 8: ViP, S2-MLP v1 and v2, RaftMLP, Swin-MLP-T, DynaMixer-T,
    MS-MLP-T, Hire-MLP-Tiny, CycleMLP-B2 and ActiveMLP-xT at full width, on
    the serving path a user calls (factory, bf16 or int8 forward,
    Predictor). They run no kernel of the port: every count is set to 0
    just before and must read 0 after."""
    x64 = images(64, 0)
    imgs = np.random.default_rng(8).integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    reset_counts(mods)  # the families' run starts here
    rates = {}
    for key in FAMILIES:
        rates[key] = family_phase(jt, key, name, x64, imgs)
        torch.cuda.empty_cache()
    launched = {m: (sum(mod.LAUNCHES.values()) if isinstance(mod.LAUNCHES, dict)
                    else mod.LAUNCHES) for m, mod in mods.items()}
    print(f"[8] port kernel launches in the families' run: {json.dumps(launched)} (want 0)",
          flush=True)
    check(not any(launched.values()), f"the families' run launched port kernels: {launched}")
    print(f"[8] b256 img/s: {json.dumps(rates)}  [{name}]", flush=True)


def grads_of(model, batch, dtype):
    """(loss, {name: gradient}) of the train step's loss on batch, the
    parameters and images cast to dtype (None: float32)."""
    from jittor_mlp_tpu_torch.parallel import loss_fn

    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, dtype)
    loss.backward()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"non-finite loss {loss.item()}")
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}


def rel_l2(got, want):
    """Global relative L2 error of tensors (sequences or dicts by key)."""
    keys = want.keys() if isinstance(want, dict) else range(len(want))
    num = sum(((got[k].float() - want[k].float()) ** 2).sum().item() for k in keys)
    return (num / sum((want[k].float() ** 2).sum().item() for k in keys)) ** 0.5


def train_batch(n, seed):
    labels = np.random.default_rng(seed).integers(0, 1000, n)
    return {"image": images(n, seed), "label": torch.from_numpy(labels).to("cuda")}


BLOCK_ARGS = ("x", "ln1w", "ln1b", "wt1", "bt1", "wt2", "bt2", "ln2w", "ln2b", "wc1", "bc1",
              "wc2", "bc2")


def train_block(mods):
    """(a) All 13 gradients of one full-shape Mixer block at B = 8: the
    kernel route against autograd of the kernel twin and against the
    recompute route, per tensor."""
    mb, bwd = mods["mixer_block"], mods["mixer_block_bwd"]
    x, w = block_inputs(8, 196, 768, 384, 3072, seed=11)
    g = _draw(12)[0](*x.shape)

    def grads(block):
        leaves = [t.detach().requires_grad_() for t in (x, *w)]
        return torch.autograd.grad(block(*leaves), leaves, g)

    kern = grads(bwd.fused_mixer_block_train)
    for tag, other in (("autograd of the kernel twin", grads(mb.mixer_block_ref)),
                       ("recompute route", grads(mb.fused_mixer_block_trainable))):
        errs = {}
        for name, a, b in zip(BLOCK_ARGS, kern, other):
            check(a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16,
                  f"block gradient {name}: {tuple(a.shape)} {a.dtype} vs {b.dtype}")
            errs[name] = rel_l2([a], [b])
        worst = max(errs, key=errs.get)
        print(f"[6a] Mixer block {tuple(x.shape)} gradients, kernel route vs {tag}: relative L2 "
              f"per tensor {' '.join(f'{k}={v:.4g}' for k, v in errs.items())}; worst {worst} "
              f"(limit {GRAD_BLOCK})", flush=True)
        check(errs[worst] <= GRAD_BLOCK, f"kernel-route block gradient {worst} vs {tag}: "
              f"{errs[worst]}")


def grad_bands(jt, batch_size=32):
    """(b) Mixer-B/16 gradients of every parameter on the kernel route, the
    recompute route and the plain bf16 path, against float32 (TF32 off)
    and against each other, as global relative L2 errors."""
    from jittor_mlp_tpu_torch import config

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    batch = train_batch(batch_size, 3)
    with config.parity_mode():
        _, ref = grads_of(model, batch, None)
    paths = {}
    for path, use_pallas, pallas_bwd in (("kernel route", True, True),
                                         ("recompute route", True, False),
                                         ("plain bf16 path", False, False)):
        model.use_pallas, config.pallas_bwd = use_pallas, pallas_bwd
        _, paths[path] = grads_of(model, batch, torch.bfloat16)
    model.use_pallas, config.pallas_bwd = True, False
    errs = {}
    for path, grads in paths.items():
        errs[f"{path} vs f32"] = (rel_l2(grads, ref), GRAD_VS_F32)
    names = list(paths)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            lim = GRAD_PLAIN if "plain" in a + b else GRAD_ROUTES
            errs[f"{a} vs {b}"] = (rel_l2(paths[a], paths[b]), lim)
    for tag, (err, lim) in errs.items():
        print(f"[6b] Mixer-B/16 b{batch_size} gradients, {tag}: global relative L2 {err:.6g} "
              f"(limit {lim})", flush=True)
    for tag, (err, lim) in errs.items():
        check(err <= lim, f"Mixer-B/16 gradients {tag}: {err} > {lim}")
    return errs


def loss_descends(jt, mods, steps=10, batch_size=128):
    """(c) AdamW steps on one batch on each route, remat off and on; (d)
    the launches per step. Returns the kernel route's launches (remat off):
    the training path's run of the four training kernels."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(batch_size, 5)
    mb, bwd = mods["mixer_block"], mods["mixer_block_bwd"]
    runs, counted = {}, {}
    for route in ("kernel", "recompute"):
        for remat in (False, True):
            model.load_state_dict(init)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
            step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
            config.pallas_bwd = route == "kernel"
            fwd_mod = bwd if route == "kernel" else mb  # the library of the block forward
            reset_counts(mods)  # the training path's run starts here
            routes0, modes0 = fwd_mod.routes(), bwd.mode_launches()
            with config.remat_mode() if remat else contextlib.nullcontext():
                losses = [step(batch).item() for _ in range(steps)]
            torch.cuda.synchronize()
            counts = {k: v for k, v in bwd.LAUNCHES.items()}
            counts["fused_mixer_block"] = mb.LAUNCHES
            config.pallas_bwd = False
            fwd = DEPTH * steps * (2 if remat else 1)
            bwd_n = DEPTH * steps if route == "kernel" else 0
            want = {"fwd_with_h": fwd if route == "kernel" else 0, "token_bwd": bwd_n,
                    "chan_data_bwd": bwd_n, "chan_wgt_bwd": bwd_n,
                    "fused_mixer_block": 0 if route == "kernel" else fwd}
            tag = f"{route} route, remat {'on' if remat else 'off'}"
            print(f"[6c] Mixer-B/16 b{batch_size} {steps} AdamW steps, {tag}: losses "
                  f"{' '.join(f'{v:.6f}' for v in losses)}", flush=True)
            print(f"[6d] launches, {tag}: {json.dumps(counts)} (want {json.dumps(want)})",
                  flush=True)
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"{tag}: the loss did not descend: {losses}")
            check(counts == want, f"{tag}: launches {counts}, want {want}")
            # the kernel route's library also runs the channel backwards' products
            products = sum(BWD_PRODUCTS.get(k, 0) * counts[k] for k in TRAIN_KERNELS) \
                if route == "kernel" else 2 * fwd
            moved = check_routes(f"[6d] {tag}, block forwards and channel backwards", routes0,
                                 fwd_mod.routes(), products)
            runs[(route, remat)] = losses
            modes = {k: v - modes0[k] for k, v in bwd.mode_launches().items()}
            want_modes = {k: sum(BWD_MODES[n].get(k, 0) * counts[n] for n in BWD_MODES)
                          for k in ("dual", "group")}
            got_modes = {k: modes[k] for k in want_modes}
            print(f"[6d] the wgmma core's dual and Group launches, {tag}: "
                  f"{json.dumps(got_modes)} (want {json.dumps(want_modes)})", flush=True)
            check(got_modes == want_modes,
                  f"{tag}: dual and Group launches {got_modes}, want {want_modes}")
            if route == "kernel" and not remat:
                counted = {k: counts[k] for k in TRAIN_KERNELS}
                counted["gemm_bwd_sm90"] = moved - BWD_PRODUCTS["fwd_with_h"] * counts["fwd_with_h"]
                counted["gemm_bf16_dual_sm90"] = modes["dual"]
                counted["gemm_bf16_group_sm90"] = modes["group"]
        check(runs[(route, True)] == runs[(route, False)],
              f"{route} route: remat changed the losses")
        print(f"[6c] {route} route: remat on gives the same losses, bit for bit", flush=True)
    return counted


def other_families(jt, mods, batch_size=32):
    """(e) One ResMLP-S24 and one gMLP-S bf16 train step; their gradients on
    the kernel path against the plain bf16 path."""
    from jittor_mlp_tpu_torch.parallel import make_train_step

    batch = train_batch(batch_size, 6)
    for tag, build, lib, depth in (
            ("ResMLP-S24", lambda: jt.ResMLPForImageClassification(**RESMLP_S24)
             .load_torch_state_dict(resmlp_state_dict(jt)), "resmlp_block", RES_DEPTH),
            ("gMLP-S", lambda: jt.gMLPForImageClassification(**GMLP_S), "gmlp_block",
             GMLP_DEPTH)):
        mod = mods[lib]
        model = build()
        model.use_pallas = False
        _, plain = grads_of(model, batch, torch.bfloat16)
        model.use_pallas = True
        before, routes0 = mod.LAUNCHES, mod.routes()
        _, kern = grads_of(model, batch, torch.bfloat16)
        check(mod.LAUNCHES == before + depth,
              f"{tag}: {mod.LAUNCHES - before} forward-kernel launches in a step, want {depth}")
        # the block forward's three products, all on wgmma
        check_routes(f"[6e] {tag} step", routes0, mod.routes(), BLOCK_PRODUCTS[lib][1] * depth)
        err = rel_l2(kern, plain)
        step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3,
                                                        weight_decay=1e-4, eps=1e-8),
                               compute_dtype=torch.bfloat16)
        loss = step(batch).item()
        print(f"[6e] {tag} b{batch_size} bf16 train step: loss {loss:.6f}; gradients of the "
              f"kernel path vs the plain bf16 path: global relative L2 {err:.6g} "
              f"(limit {GRAD_BLOCK}); {depth} forward-kernel launches a step", flush=True)
        check(np.isfinite(loss) and err <= GRAD_BLOCK, f"{tag}: loss {loss}, gradient error {err}")
        del model


def train_throughput(jt, name, batch_size=128):
    """(f) Train img/s at b128 on each path, in turns, by CUDA events."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    model = jt.MLPMixerForImageClassification(**MIXER_B16)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    batch = train_batch(batch_size, 7)
    paths = {"kernel route": (True, True), "recompute route": (True, False),
             "plain bf16 path": (False, False)}
    times = {k: [] for k in paths}
    peak = {}
    for path in list(paths) + list(paths)[::-1]:
        model.use_pallas, config.pallas_bwd = paths[path]
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: step(batch), 5))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    model.use_pallas, config.pallas_bwd = True, False
    for path, runs in times.items():
        ms = sum(runs) / len(runs)
        print(f"[6f] Mixer-B/16 bf16 train step b{batch_size}, {path}: {ms:.4f} ms, "
              f"{batch_size * 1e3 / ms:.1f} img/s (runs {runs}; peak memory "
              f"{peak[path]:.3f} GiB)  [{name}]", flush=True)


def block_throughput(jt, name, tag, model, seed, batch_size=128):
    """(f) A block family's bf16 train img/s at b128, kernel path (the block
    kernel forward, autograd of the plain block backward) and plain path in
    turns, by CUDA events, with peak memory."""
    from jittor_mlp_tpu_torch.parallel import make_train_step

    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    batch = train_batch(batch_size, seed)
    paths = {"kernel path": True, "plain bf16 path": False}
    times, peak = {k: [] for k in paths}, {}
    for path in list(paths) + list(paths)[::-1]:
        model.use_pallas = paths[path]
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: step(batch), 5))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    model.use_pallas = True
    for path, runs in times.items():
        ms = sum(runs) / len(runs)
        print(f"[6f] {tag} bf16 train step b{batch_size}, {path}: {ms:.4f} ms, "
              f"{batch_size * 1e3 / ms:.1f} img/s (runs {runs}; peak memory "
              f"{peak[path]:.3f} GiB)  [{name}]", flush=True)


def as_mlp_grads(jt, mods, batch_size=32):
    """(g) AS-MLP-T gradients of every parameter at b32 (no drop-path): the
    kernel path (the shift kernel forward and backward) against the plain
    bf16 path, and each against the plain float32 path (TF32 off), as
    global relative L2 errors; the kernel path launches the shift 48 times
    a step."""
    from jittor_mlp_tpu_torch import config

    sk = mods["axial_shift"]
    model = jt.AS_MLP(**AS_MLP_T, use_pallas=False)
    batch = train_batch(batch_size, 8)
    with config.parity_mode():
        _, ref = grads_of(model, batch, None)
    _, plain = grads_of(model, batch, torch.bfloat16)
    model.use_pallas = True
    before = sk.LAUNCHES
    _, kern = grads_of(model, batch, torch.bfloat16)
    n = sk.LAUNCHES - before
    errs = {"kernel path vs plain bf16 path": (rel_l2(kern, plain), GRAD_BLOCK),
            "kernel path vs f32": (rel_l2(kern, ref), AS_GRAD_VS_F32),
            "plain bf16 path vs f32": (rel_l2(plain, ref), AS_GRAD_VS_F32)}
    for tag, (err, lim) in errs.items():
        print(f"[6g] AS-MLP-T b{batch_size} gradients, {tag}: global relative L2 {err:.6g} "
              f"(limit {lim})", flush=True)
    print(f"[6g] AS-MLP-T: {n} shift launches in a step (want {2 * SHIFTS})", flush=True)
    check(n == 2 * SHIFTS, f"AS-MLP-T: {n} shift launches in a step, want {2 * SHIFTS}")
    for tag, (err, lim) in errs.items():
        check(err <= lim, f"AS-MLP-T gradients {tag}: {err} > {lim}")
    return errs


def as_mlp_train(jt, mods, steps=10, batch_size=128):
    """(h) AdamW steps on one batch with drop-path (rate 0.1) drawn from a
    seeded generator, remat off and on: the loss descends, remat gives the
    same losses, and the shift launches 48 times a step (72 under remat)."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.parallel import make_train_step

    sk = mods["axial_shift"]
    model = jt.AS_MLP(**AS_MLP_T)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(batch_size, 9)
    runs = {}
    for remat in (False, True):
        model.load_state_dict(init)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
        step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts(mods)  # the AS-MLP training path's run starts here
        with config.remat_mode() if remat else contextlib.nullcontext():
            losses = [step(batch, gen).item() for _ in range(steps)]
        torch.cuda.synchronize()
        n, want = sk.LAUNCHES, SHIFTS * steps * (3 if remat else 2)
        tag = f"remat {'on' if remat else 'off'}"
        print(f"[6h] AS-MLP-T b{batch_size} {steps} AdamW steps, drop_path_rate 0.1, {tag}: "
              f"losses {' '.join(f'{v:.6f}' for v in losses)}; {n} shift launches (want {want})",
              flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"AS-MLP-T {tag}: the loss did not descend: {losses}")
        check(n == want, f"AS-MLP-T {tag}: {n} shift launches, want {want}")
        runs[remat] = losses
    check(runs[True] == runs[False], "AS-MLP-T: remat changed the losses")
    print("[6h] AS-MLP-T: remat on gives the same losses, bit for bit", flush=True)


def as_mlp_throughput(jt, name, batch_size=128):
    """(i) AS-MLP-T train img/s at b128, kernel path and plain path in
    turns, drop-path on, by CUDA events, with peak memory."""
    from jittor_mlp_tpu_torch.parallel import make_train_step

    model = jt.AS_MLP(**AS_MLP_T)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    batch = train_batch(batch_size, 10)
    gen = torch.Generator(device="cuda").manual_seed(1)
    paths = {"kernel path": True, "plain bf16 path": False}
    times, peak = {k: [] for k in paths}, {}
    for path in list(paths) + list(paths)[::-1]:
        model.use_pallas = paths[path]
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: step(batch, gen), 5))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    model.use_pallas = True
    for path, runs in times.items():
        ms = sum(runs) / len(runs)
        print(f"[6i] AS-MLP-T bf16 train step b{batch_size}, {path}: {ms:.4f} ms, "
              f"{batch_size * 1e3 / ms:.1f} img/s (runs {runs}; peak memory "
              f"{peak[path]:.3f} GiB)  [{name}]", flush=True)


def phase_train(jt, mods, name):
    """Phase 6; returns the training kernels' launches on the training path."""
    train_block(mods)
    grad_bands(jt)
    counted = loss_descends(jt, mods)
    torch.cuda.empty_cache()
    other_families(jt, mods)
    torch.cuda.empty_cache()
    train_throughput(jt, name)
    torch.cuda.empty_cache()
    block_throughput(jt, name, "gMLP-S", jt.gMLPForImageClassification(**GMLP_S), 11)
    torch.cuda.empty_cache()
    block_throughput(jt, name, "ResMLP-S24", jt.ResMLPForImageClassification(**RESMLP_S24), 12)
    torch.cuda.empty_cache()
    as_mlp_grads(jt, mods)
    torch.cuda.empty_cache()
    as_mlp_train(jt, mods)
    torch.cuda.empty_cache()
    as_mlp_throughput(jt, name)
    return counted


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a only")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' f32 matmuls
    name = card()
    print(f"[1] card: {name}", flush=True)

    import importlib

    import jittor_mlp_tpu_torch as jt

    mods = {m: importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{m}")
            for m in KERNEL_MODULES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda m: m.build(), mods.values()))
    print(f"[1] kernel builds + loads ({len(mods)} in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"[1] channel-product core (gemm_sm90.cuh): {json.dumps(mods['gemm_sm90'].config())}",
          flush=True)

    table = kernel_table(mods)
    errs = phase_kernels(table)
    errs["axial_shift"] = phase_shift(mods["axial_shift"])
    errs.update(phase_lab(mods["kernel_lab"]))
    errs["gemm_tn_sm90"] = phase_gemm(mods["gemm_sm90"])
    errs.update(phase_core(mods["gemm_sm90"]))
    errs.update(phase_modes(mods["gemm_sm90"], mods["mixer_block_bwd"]))
    mixer, res, gmlp, as_mlp = phase_logits(jt, mods)
    launches = phase_serving(jt, mods, mixer, res, gmlp, as_mlp)
    del mixer, res, gmlp, as_mlp
    torch.cuda.empty_cache()
    timings = phase_timing(jt, table, name)
    timings["axial_shift"] = shift_timing(mods["axial_shift"], name)
    timings.update(lab_timing(mods["kernel_lab"], name))
    library = {}
    timings["gemm_tn_sm90"], library["gemm_tn_sm90"] = gemm_timing(mods["gemm_sm90"], name)
    for row, (timing, lib_ms) in core_timing(mods["gemm_sm90"], name).items():
        timings[row], library[row] = timing, lib_ms
    for row, (timing, lib_ms) in mode_timing(mods["gemm_sm90"], mods["mixer_block_bwd"],
                                             name).items():
        timings[row], library[row] = timing, lib_ms
    torch.cuda.empty_cache()
    launches.update(phase_train(jt, mods, name))
    torch.cuda.empty_cache()
    launches.update(phase_lab_stack(mods, name))
    torch.cuda.empty_cache()
    phase_families(jt, mods, name)

    sources = {k: (source, PALLAS + replaced)
               for k, (*_mid, source, replaced, _depth) in table.items()}
    sources["axial_shift"] = ("axial_shift.cu", SHIFT_REPLACES)
    sources.update(LAB_KERNELS)
    sources["gemm_tn_sm90"] = ("gemm_sm90.cuh", GEMM_REPLACES)
    sources["gemm_s8_sm90"] = ("gemm_sm90.cuh", S8_REPLACES)
    sources["gemm_s8_mixer_sm90"] = ("gemm_sm90.cuh", MIXER_S8_REPLACES)
    sources["gemm_bf16_gmlp_sm90"] = ("gemm_sm90.cuh", GMLP_BF16_REPLACES)
    sources["gemm_bf16_resmlp_sm90"] = ("gemm_sm90.cuh", RES_BF16_REPLACES)
    sources["gemm_s8_resmlp_sm90"] = ("gemm_sm90.cuh", RES_S8_REPLACES)
    sources["gemm_bwd_sm90"] = ("gemm_sm90.cuh", BWD_REPLACES)
    sources["gemm_bf16_dual_sm90"] = ("gemm_sm90.cuh", DUAL_REPLACES)
    sources["gemm_bf16_group_sm90"] = ("gemm_sm90.cuh", GROUP_REPLACES)
    rows = []
    for kname, (source, replaced) in sources.items():
        ms, plain_ms, bound_ms, bound_by = timings[kname]
        check(launches.get(kname, 0) > 0, f"{kname} was not launched on its path")
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"jittor_mlp_tpu_torch/csrc/{source}",
            "replaces": replaced,
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes a whole block (of any lab variant),
            # a block's backward or the zero-fill grouped shift (torch.roll
            # wraps around); the GEMM core's rows: cuBLAS's products
            "library_ms": library.get(kname),
        })
    print(f"[end] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
