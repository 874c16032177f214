"""Where the time goes on the card: torch.profiler over the serving paths
at batch 256, or over a bf16 train step at batch 128.

    python -m jittor_mlp_tpu_torch.tools.profile_blocks [--batch 256] [--iters 3] [--model M ...]
    python -m jittor_mlp_tpu_torch.tools.profile_blocks --train [--batch 128] [--model M ...]

For Mixer-B/16 (d_model 768, depth 12, token_dim 384), ResMLP-S24
(d_model 384, depth 24), gMLP-S @224 (d_model 256, d_ffn 1536, depth 30)
AS-MLP-T @224 (embed 96, depths [2, 2, 6, 2], shift 5), and the families
without a kernel of their own at compare.py's widths (ViP, S2-MLP-wide,
S2-MLPv2, RaftMLP, Swin-MLP-T, DynaMixer-T, MS-MLP-T, Hire-MLP-Tiny,
CycleMLP-B2, ActiveMLP-xT, and the BatchNorm families ConvMixer-768/32,
SparseMLP, MorphMLP-T, WaveMLP-T, ConvMLP-M and RepMLPNet-B224, whose
running statistics are first recalibrated in f32 on four random batches
of 32, and GFNet, GFNet-H-B and Sequencer2D-S) in bf16 and int8, it
profiles ``iters``
forwards after a warm-up; with ``--train``,
``iters`` bf16 mixed-precision train steps (AdamW): Mixer-B/16 on each
route, the kernel route (``config.pallas_bwd``) and the recompute route,
and AS-MLP-T (drop-path 0.1 from a seeded generator) on the kernel path
and the plain path. ``--model`` picks one model or several (the keys of
``MODELS``; by default all of them, and for ``--train`` the Mixer and
AS-MLP-T).
It prints the device time per forward or step by kind of kernel (the
port's kernels, library products, reductions, elementwise passes; the
kernels that ``torch.fft``'s and ``nn.LSTM``'s ops launch, the cuFFT
transforms with their copies and cuDNN's RNN with its products, count as
kinds of their own, "FFTs (cuFFT)" and "LSTM (cuDNN RNN)"), each
CUDA kernel's device time and share of the device time, the device-busy
share of the wall time, and the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core.train_utils import recalibrate_bn
from jittor_mlp_tpu_torch.parallel import make_train_step

MODELS = {  # --model key: (title, factory, arguments)
    "mixer": ("Mixer-B/16", jt.MLPMixerForImageClassification,
              dict(d_model=768, depth=12, token_dim=384)),
    "res_mlp": ("ResMLP-S24", jt.ResMLPForImageClassification, dict(d_model=384, depth=24)),
    "g_mlp": ("gMLP-S", jt.gMLPForImageClassification,
              dict(image_size=224, d_model=256, d_ffn=1536, depth=30)),
    "as_mlp": ("AS-MLP-T", jt.AS_MLP, {}),
    "vip": ("ViP", jt.ViP, dict(image_size=224, patch_size=14, d_model=256, depth=30,
                                segments=16, weighted=True)),
    "s2_mlp_v1": ("S2-MLP-wide", jt.S2MLPv1_wide, {}),
    "s2_mlp_v2": ("S2-MLPv2", jt.S2MLPv2, dict(image_size=224, patch_size=[7, 2],
                                               d_model=[192, 384], depth=[4, 14],
                                               expansion_factor=[3, 3])),
    "raft_mlp": ("RaftMLP", jt.RaftMLP, dict(layers=[
        {"depth": 2, "dim": 64, "patch_size": 4, "raft_size": 2},
        {"depth": 2, "dim": 128, "patch_size": 2, "raft_size": 2}])),
    "swin_mlp": ("Swin-MLP-T", jt.SwinMLP, dict(drop_path_rate=0.0)),
    "dyna_mlp": ("DynaMixer-T", jt.DynaMixer, dict(model_name="T")),
    "ms_mlp": ("MS-MLP-T", jt.MS_MLP, dict(drop_path_rate=0.0)),
    "hire_mlp": ("Hire-MLP-Tiny", jt.HireMLP, {}),
    "cycle_mlp": ("CycleMLP-B2", jt.CycleMLP_B2, {}),
    "active_mlp": ("ActiveMLP-xT", jt.models.active_mlp.ActivexTiny, {}),
    "conv_mixer": ("ConvMixer-768/32", jt.ConvMixer,
                   dict(dim=768, depth=32, kernel_size=7, patch_size=7)),
    "sparse_mlp": ("SparseMLP", jt.SparseMLP, {}),
    "repmlpnet": ("RepMLPNet-B224", jt.create_RepMLPNet_B224, {}),
    "wave_mlp": ("WaveMLP-T", jt.WaveMLP, dict(model_name="T")),
    "morph_mlp": ("MorphMLP-T", jt.MorphMLP, dict(model_name="T")),
    "conv_mlp": ("ConvMLP-M", jt.convmlp_m, {}),
    "gfnet": ("GFNet", jt.GFNet, {}),
    "gfnet_h_b": ("GFNet-H-B", jt.GFNetPyramid, dict(embed_dim=[96, 192, 384, 768],
                                                     depth=[3, 3, 27, 3], init_values=1e-6)),
    "sequencer": ("Sequencer2D-S", jt.Sequencer2D, dict(model_name="S")),
}


def _device_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


# kinds of their own, by the op that launched the kernel (an op of the list
# at or above it)
OP_KINDS = (("LSTM (cuDNN RNN)", ("aten::lstm",)),
            ("FFTs (cuFFT)", ("aten::fft_rfft2", "aten::fft_irfft2", "aten::_fft_r2c",
                              "aten::_fft_c2r")))


def _op_kind(name):
    return next((k for k, ops in OP_KINDS if name in ops), None)


def op_kernels(events, iters):
    """{(kernel, kind): device ms per call} of the kernels launched inside
    an op of OP_KINDS. Each kernel is read off the ``aten::`` op it is
    correlated with (``torch.profiler``'s CPU events carry the kernels
    their op launched); a runtime event under it (``cuLaunchKernel``,
    "Command Buffer Full") can carry the same kernel again and is skipped."""
    out = {}
    for e in events:
        if not e.name.startswith("aten::") or not e.kernels:
            continue
        k, node = None, e
        while node is not None:
            k = _op_kind(node.name) or k
            node = node.cpu_parent
        for kern in e.kernels if k else ():
            out[(kern.name, k)] = out.get((kern.name, k), 0.0) + kern.duration / 1e3 / iters
    return out


def profile(run, iters):
    """Profile ``iters`` calls of run() after one warm-up call; returns
    ([(kernel, device ms per call, launches per call)], wall ms per call,
    ``op_kernels``)."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU ops that launched them carry the
    # same time again
    rows = [(e.key, _device_us(e) / 1e3 / iters, e.count // iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    return sorted(rows, key=lambda r: -r[1]), wall_ms / iters, op_kernels(prof.events(), iters)


KINDS = (  # (kind, substrings of the kernel names), first match wins
    ("axial shift", ("axial_shift",)),
    ("port kernels", ("jmt::", "layer_norm_kernel", "affine_kernel", "quant_rows", "row_stats",
                      "row_sum", "col_sum", "sum_groups", "ln_bwd", "ln_grad")),
    # cuDNN's implicit-GEMM convolutions carry "gemm" and "xmma" in their names too
    ("convolutions", ("fprop", "cudnn", "conv2d", "conv_depthwise", "convolution")),
    ("library products", ("gemm", "nvjet", "xmma", "cutlass", "gemv", "dot_kernel")),
    ("gathers", ("gather", "indexSelect", "index_elementwise", "scatter")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy")),
)


def kind(key):
    return next((k for k, marks in KINDS if any(m in key for m in marks)), "other")


def report(title, rows, wall, top, by_op=None):
    """``by_op`` (``op_kernels``): the kernels' time inside those ops goes
    to the op's kind, the rest of each kernel's time to its own."""
    busy = sum(r[1] for r in rows)
    print(f"\n{title}: wall {wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    by_op, by_kind = by_op or {}, {}
    for (_, k), ms in by_op.items():
        by_kind[k] = by_kind.get(k, 0.0) + ms
    for key, ms, _ in rows:
        ms -= sum(v for (kern, _), v in by_op.items() if kern == key)
        by_kind[kind(key)] = by_kind.get(kind(key), 0.0) + ms
    print("  by kind: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in
                                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
    print(f"  {'ms':>9} {'share':>6} {'calls':>5}  kernel")
    for key, ms, calls in rows[:top]:
        print(f"  {ms:9.4f} {100 * ms / busy:5.1f}% {calls:5d}  {key[:110]}")


def serving(batch, iters, keys):
    x = torch.randn(batch, 3, 224, 224, device="cuda").bfloat16()
    for key in keys:
        name, factory, kw = MODELS[key]
        model = recalibrate_bn(factory(**kw), torch.randn(4, 32, 3, 224, 224, device="cuda"))
        model = model.to_bf16().eval()
        for int8 in (False, True):
            with torch.inference_mode(), config.int8_mode() if int8 else contextlib.nullcontext():
                rows, wall, by_op = profile(lambda: model.forward(x), iters)
            report(f"{name} b{batch} {'int8' if int8 else 'bf16'} forward", rows, wall, 14, by_op)
        del model
        torch.cuda.empty_cache()


def training(batch, iters, keys):
    rng = np.random.default_rng(0)
    data = {"image": torch.from_numpy(rng.standard_normal((batch, 3, 224, 224), np.float32)).cuda(),
            "label": torch.from_numpy(rng.integers(0, 1000, batch)).cuda()}
    for key in keys:
        name, factory, kw = MODELS[key]
        model = factory(**kw)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
        step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
        if key == "mixer":
            for route, pallas_bwd in (("kernel route", True), ("recompute route", False)):
                config.pallas_bwd = pallas_bwd
                rows, wall, _ = profile(lambda: step(data), iters)
                report(f"{name} b{batch} bf16 train step, {route}", rows, wall, 24)
            config.pallas_bwd = False
        elif key == "as_mlp":
            gen = torch.Generator(device="cuda").manual_seed(0)
            for path, use_pallas in (("kernel path", True), ("plain path", False)):
                model.use_pallas = use_pallas
                rows, wall, _ = profile(lambda: step(data, gen), iters)
                report(f"{name} b{batch} bf16 train step, {path}", rows, wall, 24)
        else:
            rows, wall, _ = profile(lambda: step(data), iters)
            report(f"{name} b{batch} bf16 train step", rows, wall, 24)
        del model, opt, step
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile train steps, not forwards")
    ap.add_argument("--batch", type=int, default=None, help="256 (serving) or 128 (--train)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--model", nargs="+", choices=["all", *MODELS], default=["all"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_blocks needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    every = "all" in args.model
    if args.train:
        training(args.batch or 128, args.iters, ["mixer", "as_mlp"] if every else args.model)
    else:
        serving(args.batch or 256, args.iters, list(MODELS) if every else args.model)


if __name__ == "__main__":
    main()
