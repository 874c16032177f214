#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

Builds the port's CUDA kernel from this checkout, checks it against its
plain PyTorch twin, then drives the port's main path — Mixer-B/16 @224
(d_model 768, depth 12, token_dim 384, random weights from seed 0) served in
bf16 through ``Predictor`` and ``MicroBatcher`` — and times kernel against
plain. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each one fails loudly; there is no CPU fallback):
  1. the card and the kernel build time;
  2. fused_mixer_block kernel vs mixer_block_ref, bf16, at the Mixer-B/16
     block shape (B=8) and two ragged small shapes, within 1.6e-2 of
     max(1, max|ref|);
  3. Mixer-B/16 logits: kernel path vs plain bf16 path, and vs the float32
     plain forward (TF32 off), on 64 random images; 12 launches a forward;
  4. serving: Predictor(batch_size=32).warmup(), 64 uint8 224×224 requests
     through MicroBatcher from 8 threads, each equal to predict() of the
     image alone, and 2 requests at 256×256 (the resize path);
  5. CUDA-event timings: one block at b256 and the whole forward at b256,
     kernel vs plain.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TOL = 1.6e-2  # two bf16 ulps of the output scale
MIXER_B16 = dict(d_model=768, depth=12, token_dim=384)
DEPTH = MIXER_B16["depth"]  # one kernel launch per block


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


def block_inputs(B, N, D, TD, CD, seed):
    """bf16 block inputs on the card, from a seeded CUDA generator.

    Weights are scaled by 1/sqrt(fan_in) and biases drawn with std 0.5, so
    the outputs are O(1) and one misplaced bias element moves an output by
    far more than the tolerance band."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    def ln():  # LayerNorm weight, bias (D,)
        return 1 + rn(D, scale=0.1), rn(D, scale=0.1)

    def lin(out, fan_in):  # weight (out, fan_in), bias (out,)
        return rn(out, fan_in, scale=fan_in ** -0.5), rn(out, scale=0.5)

    x = torch.randn(B, N, D, generator=g, device="cuda").bfloat16()
    w = (*ln(), *lin(TD, N), *lin(N, TD), *ln(), *lin(CD, D), *lin(D, CD))
    return x, w


def phase_kernel(mb):
    """Kernel vs twin at the Mixer-B/16 block shape (several tiles in M, N
    and K of every GEMM, ragged N = 196), a ragged shape inside one 128×128
    tile, and a ragged shape spanning several tiles in M, N and K of the
    channel GEMMs and in N and K of the token GEMMs. Returns the largest
    max|Δ| over the three."""
    errs = {}
    for shape in [(8, 196, 768, 384, 3072), (3, 20, 40, 24, 72), (5, 33, 136, 50, 200)]:
        x, w = block_inputs(*shape, seed=sum(shape))
        before = mb.LAUNCHES
        got = mb.fused_mixer_block(x, *w)
        torch.cuda.synchronize()
        check(mb.LAUNCHES == before + 1, f"LAUNCHES did not rise by 1 at {shape}")
        want = mb.mixer_block_ref(x, *w)
        check(got.shape == want.shape and got.dtype == torch.bfloat16,
              f"kernel output {tuple(got.shape)} {got.dtype} at {shape}")
        check(bool(torch.isfinite(got).all()), f"non-finite kernel output at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(1.0, want.float().abs().max().item())
        print(f"[2] block kernel vs twin (B,N,D,TD,CD)={shape}: max|d|={err:.6g} "
              f"max|d|/max(1,max|ref|)={rel:.6g} (limit {TOL})", flush=True)
        check(rel <= TOL, f"kernel disagrees with its twin at {shape}: {rel}")
        errs[shape] = err
    return max(errs.values())


def phase_logits(jt, mb):
    from jittor_mlp_tpu_torch import config

    kernel = jt.MLPMixerForImageClassification(**MIXER_B16).to("cuda").to_bf16().eval()
    plain = jt.MLPMixerForImageClassification(**MIXER_B16, use_pallas=False)
    plain = plain.to("cuda").to_bf16().eval()
    f32 = jt.MLPMixerForImageClassification(**MIXER_B16).to("cuda").eval()
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 3, 224, 224), np.float32)
    ).to("cuda")
    with torch.inference_mode():
        before = mb.LAUNCHES
        lk = kernel.forward(x.bfloat16()).float()
        torch.cuda.synchronize()
        check(mb.LAUNCHES == before + DEPTH,
              f"{mb.LAUNCHES - before} kernel launches in one forward, want {DEPTH}")
        lp = plain.forward(x.bfloat16()).float()
        with config.parity_mode():
            lf = f32.forward(x)
    check(lk.shape == (64, 1000) and bool(torch.isfinite(lk).all()),
          f"kernel-path logits {tuple(lk.shape)} not finite/shaped")
    for name, ref, lim_rel, lim_top1 in (("plain bf16", lp, 5e-2, 0.9),
                                         ("f32 plain (TF32 off)", lf, 5e-2, 0.9)):
        rel = ((lk - ref).abs().max() / ref.abs().max()).item()
        top1 = (lk.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"[3] Mixer-B/16 kernel path vs {name}: max|dlogit|/max|logit|={rel:.6g} "
              f"top1 agreement={top1:.4f} (64 images)", flush=True)
        check(rel <= lim_rel and top1 >= lim_top1,
              f"kernel path vs {name}: rel {rel}, top-1 {top1}")
    del plain, f32
    return kernel


def phase_serving(jt, mb, model):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    mb.LAUNCHES = 0  # the main path's run starts here
    pred = jt.Predictor(model, batch_size=32).warmup()
    results = [None] * 64
    errors = []
    with jt.MicroBatcher(pred, max_delay_ms=5.0) as batcher:
        def client(k):
            try:
                for i in range(k, 64, 8):
                    results[i] = batcher.submit(imgs[i])
            except Exception as e:  # reported below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "a MicroBatcher client did not finish")
        stats = batcher.stats()
    check(not errors, f"MicroBatcher request failed: {errors[:1]}")
    check(all(r is not None for r in results), "a request got no answer")
    for i in range(64):
        labels, probs = pred.predict(imgs[i:i + 1])
        check(np.array_equal(results[i][0], labels[0]),
              f"request {i}: batched labels {results[i][0]} != alone {labels[0]}")
        check(np.abs(results[i][1] - probs[0]).max() <= 1e-3,
              f"request {i}: batched probs differ from predict alone")
    labels, probs = pred.predict(big)
    check(labels.shape == probs.shape == (2, 5) and np.isfinite(probs).all()
          and (probs >= 0).all() and (probs.sum(-1) <= 1 + 1e-5).all(),
          "resize-path requests gave malformed results")
    launches = mb.LAUNCHES
    forwards = pred.latency_stats()["count"]
    print(f"[4] served 64 requests via MicroBatcher (8 threads) + 64 predict + "
          f"2 resized (256x256); all answered, batched == alone", flush=True)
    print(f"[4] MicroBatcher.stats: {json.dumps(stats)}", flush=True)
    print(f"[4] Predictor.latency_stats: {json.dumps(pred.latency_stats())}", flush=True)
    print(f"[4] kernel launches in the serving run: {launches} "
          f"({forwards} forwards x {DEPTH} blocks)", flush=True)
    check(launches == DEPTH * forwards,
          f"{launches} kernel launches for {forwards} forwards, want {DEPTH} each")
    return launches


def phase_timing(jt, mb, name):
    x, w = block_inputs(256, 196, 768, 384, 3072, seed=7)
    block_ms = cuda_ms(lambda: mb.fused_mixer_block(x, *w), 10)
    ref_ms = cuda_ms(lambda: mb.mixer_block_ref(x, *w), 10)
    print(f"[5] one Mixer-B/16 block, b256 bf16: kernel {block_ms:.4f} ms, "
          f"mixer_block_ref {ref_ms:.4f} ms  [{name}]", flush=True)
    del x, w
    kernel = jt.MLPMixerForImageClassification(**MIXER_B16).to("cuda").to_bf16().eval()
    plain = jt.MLPMixerForImageClassification(**MIXER_B16, use_pallas=False)
    plain = plain.to("cuda").to_bf16().eval()
    xb = torch.randn(256, 3, 224, 224, device="cuda").bfloat16()
    times = {"kernel": [], "plain": []}
    with torch.inference_mode():
        for which in ("plain", "kernel", "kernel", "plain"):
            m = kernel if which == "kernel" else plain
            times[which].append(cuda_ms(lambda: m.forward(xb), 5))
    for which in ("kernel", "plain"):
        ms = sum(times[which]) / 2
        print(f"[5] Mixer-B/16 forward b256 bf16, {which} path: {ms:.4f} ms, "
              f"{256e3 / ms:.1f} img/s (runs {times[which]})  [{name}]", flush=True)
    return block_ms, ref_ms


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a only")
    name = card()
    print(f"[1] card: {name}", flush=True)

    import jittor_mlp_tpu_torch as jt
    from jittor_mlp_tpu_torch.ops.kernels import mixer_block as mb

    t0 = time.perf_counter()
    mb.build()
    print(f"[1] kernel build + load: {time.perf_counter() - t0:.2f} s", flush=True)

    max_abs_err = phase_kernel(mb)
    model = phase_logits(jt, mb)
    launches = phase_serving(jt, mb, model)
    del model
    torch.cuda.empty_cache()
    block_ms, ref_ms = phase_timing(jt, mb, name)

    print(json.dumps({"kernels": [{
        "name": "fused_mixer_block",
        "route": "cuda",
        "source": "jittor_mlp_tpu_torch/csrc/mixer_block.cu",
        "replaces": "jittor_mlp_tpu/ops/pallas/mixer_block.py:157",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": block_ms,
        "plain_ms": ref_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
