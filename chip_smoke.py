#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100 (sm_90a).

Builds the port's six CUDA kernels from this checkout (one nvcc each, all
at once), checks each against its plain PyTorch twin, then drives the
port's serving paths through ``Predictor`` and ``MicroBatcher`` and times
kernels against plain versions. Models: Mixer-B/16 @224 (d_model 768,
depth 12, token_dim 384; bench.py's config), ResMLP-S24 @224 (d_model
384, depth 24, expansion 4; compare.py's) and gMLP-S @224 (d_model 256,
d_ffn 1536, depth 30; compare.py's), full width and depth, random weights
from seed 0. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each one fails loudly; there is no CPU fallback):
  1. the card and the kernels' build time;
  2. every kernel vs its twin at the full block shape (B=8), two ragged
     small shapes and, for the W8A8 Mixer and ResMLP kernels, a chunked
     shape (CD ≥ 2048, ragged chunk and tokens), within 1.6e-2 of
     max(1, max|ref|);
  3. logits on 64 random images: Mixer-B/16 bf16 kernel path vs the plain
     bf16 path and the float32 forward (TF32 off); Mixer-B/16 int8 vs the
     bf16 kernel path and f32; ResMLP-S24 (γ = 0.1, perturbed affines)
     bf16 kernel path vs plain bf16 and f32, int8 vs f32; gMLP-S the same,
     and its blocks must move the logits (vs channel_proj2 zeroed) by at
     least 10x the kernel path's deviation from f32. Bands: bf16 5e-2 of
     max|logit| and 90% top-1, int8 0.1 and 90%. Launches rise by depth
     per forward;
  4. serving: (a) Mixer-B/16 bf16 Predictor(batch_size=32) behind
     MicroBatcher, 64 requests from 8 threads plus 2 resized ones;
     (b) Mixer-B/16 compute="int8" and bf16 Predictors on one model, and
     (c) ResMLP-S24 and (e) gMLP-S int8 and bf16 Predictors on one model,
     each pair served at the same time from 8 threads, so that an int8
     flag shared between threads would show; every batched answer equals
     predict() alone; launches equal depth × forwards per kernel;
     (d) ResMLP-S24 and (f) gMLP-S weights="int8" Predictors agree with
     the bf16 ones;
  5. CUDA-event timings at b256: each kernel vs its twin; the forwards
     kernel vs plain (Mixer-B/16 and gMLP-S bf16) and int8 vs bf16 (all
     three models).

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
MIXER_B16 = dict(d_model=768, depth=12, token_dim=384)
RESMLP_S24 = dict(d_model=384, depth=24, expansion_factor=4)
GMLP_S = dict(image_size=224, patch_size=16, d_model=256, d_ffn=1536, depth=30)
DEPTH = MIXER_B16["depth"]  # one kernel launch per block
RES_DEPTH = RESMLP_S24["depth"]
GMLP_DEPTH = GMLP_S["depth"]
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


def kernel_table(mods):
    """name → (module, wrapper, twin, inputs, shapes, source, replaced, depth)."""
    mixer_shapes = [(8, 196, 768, 384, 3072), (3, 20, 40, 24, 72), (5, 33, 136, 50, 200)]
    res_shapes = [(8, 196, 384, 1536), (3, 20, 40, 72), (5, 33, 136, 200)]
    gmlp_shapes = [(8, 196, 256, 1536), (3, 20, 40, 72), (5, 33, 136, 200)]
    return {
        "fused_mixer_block": (
            mods["mixer_block"], "fused_mixer_block", "mixer_block_ref", block_inputs,
            mixer_shapes, "mixer_block.cu", "mixer_block.py:157", DEPTH),
        "fused_mixer_block_int8": (
            mods["mixer_block_int8"], "fused_mixer_block_int8", "mixer_block_int8_ref",
            block_inputs, mixer_shapes + [(2, 33, 136, 50, 2056)],
            "mixer_block_int8.cu", "mixer_block_int8.py:121", DEPTH),
        "fused_resmlp_block": (
            mods["resmlp_block"], "fused_resmlp_block", "resmlp_block_ref", resmlp_inputs,
            res_shapes, "resmlp_block.cu", "resmlp_block.py:54", RES_DEPTH),
        "fused_resmlp_block_int8": (
            mods["resmlp_block_int8"], "fused_resmlp_block_int8", "resmlp_block_int8_ref",
            resmlp_inputs, res_shapes + [(2, 33, 136, 2056)],
            "resmlp_block_int8.cu", "resmlp_block_int8.py:69", RES_DEPTH),
        "fused_gmlp_block": (
            mods["gmlp_block"], "fused_gmlp_block", "gmlp_block_ref", gmlp_inputs,
            gmlp_shapes, "gmlp_block.cu", "gmlp_block.py:57", GMLP_DEPTH),
        "fused_gmlp_block_int8": (
            mods["gmlp_block_int8"], "fused_gmlp_block_int8", "gmlp_block_int8_ref",
            gmlp_inputs, gmlp_shapes, "gmlp_block_int8.cu", "gmlp_block_int8.py:61",
            GMLP_DEPTH),
    }


def phase_kernels(table):
    """Each kernel vs its twin at its shapes; returns name → largest max|Δ|."""
    errs = {}
    for name, (mod, fn, ref, inputs, shapes, *_rest) in table.items():
        errs[name] = 0.0
        for shape in shapes:
            x, w = inputs(*shape, seed=sum(shape))
            before = mod.LAUNCHES
            got = getattr(mod, fn)(x, *w)
            torch.cuda.synchronize()
            check(mod.LAUNCHES == before + 1, f"{name}: LAUNCHES did not rise by 1 at {shape}")
            want = getattr(mod, ref)(x, *w)
            check(got.shape == want.shape and got.dtype == torch.bfloat16,
                  f"{name}: output {tuple(got.shape)} {got.dtype} at {shape}")
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output at {shape}")
            err = (got.float() - want.float()).abs().max().item()
            rel = err / max(1.0, want.float().abs().max().item())
            print(f"[2] {name} vs twin {shape}: max|d|={err:.6g} "
                  f"max|d|/max(1,max|ref|)={rel:.6g} (limit {TOL})", flush=True)
            check(rel <= TOL, f"{name} disagrees with its twin at {shape}: {rel}")
            errs[name] = max(errs[name], err)
    return errs


def images(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, 3, 224, 224), np.float32)).to("cuda")


def rel_dev(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def compare_logits(tag, got, ref, lim_rel, lim_top1):
    rel = rel_dev(got, ref)
    top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"[3] {tag}: max|dlogit|/max|logit|={rel:.6g} top1 agreement={top1:.4f} "
          f"(64 images; limits {lim_rel}, {lim_top1})", flush=True)
    check(rel <= lim_rel and top1 >= lim_top1, f"{tag}: rel {rel}, top-1 {top1}")


def forward_counted(model, x, mod, want):
    """model.forward(x) in float32 logits; mod's kernel launched `want` times."""
    before = mod.LAUNCHES
    out = model.forward(x).float()
    torch.cuda.synchronize()
    check(mod.LAUNCHES == before + want,
          f"{mod.LAUNCHES - before} {mod.__name__} launches in one forward, want {want}")
    check(bool(torch.isfinite(out).all()), "non-finite logits")
    return out


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
        lk = forward_counted(kernel, x.bfloat16(), mb, DEPTH)
        with config.int8_mode():
            lq = forward_counted(kernel, x.bfloat16(), mbq, DEPTH)
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
        rk = forward_counted(res, x.bfloat16(), rb, RES_DEPTH)
        with config.int8_mode():
            rq = forward_counted(res, x.bfloat16(), rbq, RES_DEPTH)
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
        gk = forward_counted(gmlp, x.bfloat16(), gb, GMLP_DEPTH)
        with config.int8_mode():
            gq = forward_counted(gmlp, x.bfloat16(), gbq, GMLP_DEPTH)
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
    return kernel, res, gmlp


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


def phase_serving(jt, mods, mixer, res, gmlp):
    """(a) the bf16 Mixer serving run; (b), (c), (e) int8 and bf16 Predictors
    of one model served at the same time; (d), (f) weights="int8". Each path runs
    with every launch count set to 0 just before it and read just after.
    Returns name → launches on that kernel's path."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    launches = {}

    # (a) Mixer-B/16 bf16, as the first slice serves it
    reset_counts(mods)  # the main path's run starts here
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

    # (b), (c): an int8 and a bf16 Predictor on one model, at the same time
    for tag, model, bf_mod, q_mod, depth, bf_name, q_name in (
            ("[4b] Mixer-B/16", mixer, "mixer_block", "mixer_block_int8", DEPTH,
             "fused_mixer_block", "fused_mixer_block_int8"),
            ("[4c] ResMLP-S24", res, "resmlp_block", "resmlp_block_int8", RES_DEPTH,
             "fused_resmlp_block", "fused_resmlp_block_int8"),
            ("[4e] gMLP-S", gmlp, "gmlp_block", "gmlp_block_int8", GMLP_DEPTH,
             "fused_gmlp_block", "fused_gmlp_block_int8")):
        reset_counts(mods)
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
    return launches


def block_bound(name, x, w):
    """(bound_ms, bound_by) of one block call from its inputs: each input
    read once and the output written once at the HBM rate, against the
    block's products at the dense tensor-core peak of its type."""
    nbytes = 2 * x.numel() * x.element_size() + sum(t.numel() * t.element_size() for t in w)
    B, N, D = x.shape
    if name.startswith("fused_mixer_block"):
        TD, CD = w[2].shape[0], w[8].shape[0]
        ops = 2 * B * N * D * (2 * TD + 2 * CD)
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


def phase_timing(jt, table, name):
    from jittor_mlp_tpu_torch import config

    timings = {}
    for kname, (mod, fn, ref, inputs, shapes, *_rest) in table.items():
        shape = (256, *shapes[0][1:])
        x, w = inputs(*shape, seed=7)
        ms = cuda_ms(lambda: getattr(mod, fn)(x, *w), 10)
        plain_ms = cuda_ms(lambda: getattr(mod, ref)(x, *w), 5)
        bound_ms, bound_by = block_bound(kname, x, w)
        print(f"[5] {kname} b256 {shape}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})  [{name}]", flush=True)
        timings[kname] = (ms, plain_ms, bound_ms, bound_by)
        del x, w
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
    return timings


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a only")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' f32 matmuls
    name = card()
    print(f"[1] card: {name}", flush=True)

    import importlib

    import jittor_mlp_tpu_torch as jt

    mods = {m: importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{m}")
            for m in ("mixer_block", "mixer_block_int8", "resmlp_block", "resmlp_block_int8",
                      "gmlp_block", "gmlp_block_int8")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda m: m.build(), mods.values()))
    print(f"[1] kernel builds + loads ({len(mods)} in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    table = kernel_table(mods)
    errs = phase_kernels(table)
    mixer, res, gmlp = phase_logits(jt, mods)
    launches = phase_serving(jt, mods, mixer, res, gmlp)
    del mixer, res, gmlp
    torch.cuda.empty_cache()
    timings = phase_timing(jt, table, name)

    rows = []
    for kname, (mod, *_mid, source, replaced, _depth) in table.items():
        ms, plain_ms, bound_ms, bound_by = timings[kname]
        check(launches.get(kname, 0) > 0, f"{kname} was not launched on its serving path")
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"jittor_mlp_tpu_torch/csrc/{source}",
            "replaces": f"jittor_mlp_tpu/ops/pallas/{replaced}",
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes a whole block
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
