"""The port's per-model harness (counterpart of the repository's
``compare.py``): throughput, serving numerics, training throughput and a
card-vs-CPU parity column for each model of ``CONFIGS``, one JSON record per
model per run.

Where the JAX harness holds each model against the reference's PyTorch
models, this one holds the card's float32 forward against the same weights'
CPU forward (``run_parity``). Every measurement runs on ``--device`` (the
card by default; there is no CPU fallback) and every record names the card
and its power limit as ``nvidia-smi`` reads them. Run from the repository
root:

    python -m jittor_mlp_tpu_torch.tools.compare --model mlp_mixer [--batch 32] [--iters 20]
    python -m jittor_mlp_tpu_torch.tools.compare --all --batch 256 --int8 \\
        --serving-numerics --skip-parity --json jittor_mlp_tpu_torch/sweeps/serving_h100.jsonl
    python -m jittor_mlp_tpu_torch.tools.compare --all --train --try-remat --batch 32 \\
        --skip-throughput --skip-parity --json jittor_mlp_tpu_torch/sweeps/train_h100.jsonl
    python -m jittor_mlp_tpu_torch.tools.compare --list

``--all`` runs each model in a process of its own and appends its record to
``--json``; ``python -m jittor_mlp_tpu_torch.tools.gen_tuned`` turns the two
sweeps into ``jittor_mlp_tpu_torch/tuned.py``. The exit code is 1 when a
model's parity fails or its training raised (``train_error``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# sweep key -> (reference module, reference class, the port's factory name
# (None: reached through models.<module>.<class>), kwargs): compare.py's
# CONFIGS, the reference harness's benchmark configs
CONFIGS = {
    # Mixer-B/16
    "mlp_mixer": ("mlp_mixer", "MLPMixerForImageClassification",
                  "MLPMixerForImageClassification",
                  dict(image_size=224, patch_size=16, d_model=768, depth=12)),
    "g_mlp": ("g_mlp", "gMLPForImageClassification", "gMLPForImageClassification",
              dict(image_size=224, patch_size=16, d_model=256, d_ffn=1536, depth=30)),
    # ResMLP-S24
    "res_mlp": ("res_mlp", "ResMLPForImageClassification",
                "ResMLPForImageClassification",
                dict(image_size=224, patch_size=16, d_model=384, depth=24)),
    "vip": ("vip", "ViP", "ViP",
            dict(image_size=224, patch_size=14, d_model=256, depth=30, segments=16,
                 weighted=True)),
    # ConvMixer-768/32
    "conv_mixer": ("conv_mixer", "ConvMixer", "ConvMixer",
                   dict(dim=768, depth=32, kernel_size=7, patch_size=7)),
    "s2_mlp_v2": ("s2_mlp_v2", "S2MLPv2", "S2MLPv2",
                  dict(image_size=224, patch_size=[7, 2], d_model=[192, 384],
                       depth=[4, 14], expansion_factor=[3, 3])),
    "sparse_mlp": ("sparse_mlp", "SparseMLP", "SparseMLP", dict()),
    "hire_mlp": ("hire_mlp", "HireMLP", "HireMLP", dict()),
    "gfnet": ("gfnet", "GFNet", "GFNet", dict()),
    # GFNet-H-B: the hierarchical pyramid variant
    "gfnet_h_b": ("gfnet", "GFNetPyramid", "GFNetPyramid",
                  dict(embed_dim=[96, 192, 384, 768], depth=[3, 3, 27, 3],
                       init_values=1e-6)),
    "cycle_mlp": ("cycle_mlp", "CycleMLP_B2", "CycleMLP_B2", dict()),
    "as_mlp": ("as_mlp", "AS_MLP", "AS_MLP", dict()),
    "swin_mlp": ("swin_mlp", "SwinMLP", "SwinMLP", dict(drop_path_rate=0.0)),
    "repmlpnet": ("repmlpnet", "create_RepMLPNet_B224", "create_RepMLPNet_B224", dict()),
    "wave_mlp": ("wave_mlp", "WaveMLP", "WaveMLP", dict(model_name="T")),
    "ms_mlp": ("ms_mlp", "MS_MLP", "MS_MLP", dict(drop_path_rate=0.0)),
    "morph_mlp": ("morph_mlp", "MorphMLP", "MorphMLP", dict(model_name="T")),
    "dyna_mlp": ("dyna_mlp", "DynaMixer", "DynaMixer", dict(model_name="T")),
    "sequencer": ("sequencer", "Sequencer2D", "Sequencer2D", dict(model_name="S")),
    "active_mlp": ("active_mlp", "ActivexTiny", None, dict()),
    "s2_mlp_v1": ("s2_mlp_v1", "S2MLPv1_wide", "S2MLPv1_wide", dict()),
    # ConvMLP-M
    "conv_mlp": ("conv_mlp", "convmlp_m", "convmlp_m", dict()),
    "raft_mlp": ("raft_mlp", "RaftMLP", "RaftMLP",
                 dict(layers=[
                     {"depth": 2, "dim": 64, "patch_size": 4, "raft_size": 2},
                     {"depth": 2, "dim": 128, "patch_size": 2, "raft_size": 2},
                 ])),
}

# run_parity's gate: the card's f32 logits within this share of max|logit|
# of the CPU's (chip_smoke.py's card-vs-CPU band)
PARITY_BAND = 1e-3
# BatchNorm recalibration before parity and the numerics: the JAX harness's
# two seeded batches of four images (tests/ref_loader.recalibrate_ref_bn)
RECAL_BATCHES, RECAL_IMAGES, RECAL_SEED = 2, 4, 123


def factory_of(name):
    """The port's factory of sweep key ``name``."""
    import jittor_mlp_tpu_torch as jt

    ref_mod, ref_cls, our_name, _ = CONFIGS[name]
    if our_name:
        return getattr(jt, our_name)
    import importlib

    return getattr(importlib.import_module(f"jittor_mlp_tpu_torch.models.{ref_mod}"), ref_cls)


def build_ours(name, device="cuda"):
    """The model of sweep key ``name`` at its CONFIGS kwargs, seed-0
    weights, on ``device``."""
    return factory_of(name)(**CONFIGS[name][3], device=device)


def card(device):
    """(name, power limit) of the card ``device`` names, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them; ("cpu",
    None) for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu", None
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    name, limit = (s.strip() for s in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return name, limit


def calibrated(model, image_size=224):
    """``model`` with every BatchNorm's running statistics recalibrated
    (``core/train_utils.recalibrate_bn``) on RECAL_BATCHES seeded normal
    batches: at the draw's mean 0 and var 1 a deep BatchNorm stack's eval
    forward grows without bound and its logits say nothing. Returns
    (model, whether it had any BatchNorm)."""
    from jittor_mlp_tpu_torch.core import train_utils

    if not any(k.endswith("running_mean") for k, _ in model.named_buffers()):
        return model, False
    rng = np.random.default_rng(RECAL_SEED)
    batches = [rng.standard_normal((RECAL_IMAGES, 3, image_size, image_size), np.float32)
               for _ in range(RECAL_BATCHES)]
    return train_utils.recalibrate_bn(model, batches), True


def run_parity(name, batch=2, image_size=224, device="cuda"):
    """The card's float32 forward (``config.parity_mode``: TF32 off) against
    the same weights' CPU float32 forward on one seeded batch. BatchNorm
    families are recalibrated first (``calibrated``, on the CPU). Returns the
    record's parity fields: max and mean |d|, max |d|/max(|ref|, 1e-6),
    max|ref| and ``parity_ok`` (max |d| ≤ PARITY_BAND · max|ref|). The
    statistics are reduced on ``device`` and read back once."""
    from jittor_mlp_tpu_torch import config

    ref_model, recalibrated = calibrated(build_ours(name, "cpu").eval(), image_size)
    ours = copy.deepcopy(ref_model).place(device)
    x = torch.randn(batch, 3, image_size, image_size, generator=torch.Generator().manual_seed(1))
    with config.parity_mode(), torch.inference_mode():
        t0 = time.perf_counter()
        want = ref_model(x).float()
        t_ref = time.perf_counter() - t0
        got = ours(x).float()
        want = want.to(got.device)
        diff = (got - want).abs()
        rel = diff / want.abs().clamp_min(1e-6)
        stats = torch.stack([diff.max(), diff.mean(), rel.max(), want.abs().max()]).tolist()
    max_abs, mean_abs, max_rel, out_scale = stats
    return {
        "params": ours.param_count(),
        "max_abs": max_abs,
        "mean_abs": mean_abs,
        "max_rel": max_rel,
        "out_scale": out_scale,
        "bn_recalibrated": recalibrated,
        "parity_ok": bool(max_abs <= PARITY_BAND * out_scale),
        "cpu_fwd_ms": t_ref * 1e3,
    }


def run_throughput(name, batch=32, iters=20, image_size=224, int8=False, device="cuda"):
    """bf16 images/s of the model's forward (``utils/timing.throughput``:
    CUDA events, best of its repeats). ``int8=True`` measures the dynamic
    W8A8 serving path (``config.int8_mode``), where the Mixer, ResMLP and
    gMLP blocks run their W8A8 kernels."""
    from jittor_mlp_tpu_torch import config
    from jittor_mlp_tpu_torch.utils.timing import throughput

    ours = build_ours(name, device).eval().to_bf16()
    with config.bf16_mode(), (config.int8_mode() if int8 else contextlib.nullcontext()):
        return throughput(ours, (batch, 3, image_size, image_size), iters=iters,
                          dtype=torch.bfloat16, device=device)


def serving_stats(f32, b16, q8):
    """The seven serving statistics of three logit batches (N, classes): the
    max and mean |bf16 − f32| and |int8 − f32| over max|f32|, and the top-1
    agreements bf16 vs f32, int8 vs f32 and int8 vs bf16. Reduced on the
    logits' device and read back once."""
    f, b, q = f32.float(), b16.float(), q8.float()
    scale = f.abs().max().clamp_min(1e-6)
    af, ab, aq = f.argmax(-1), b.argmax(-1), q.argmax(-1)
    stats = torch.stack([
        (b - f).abs().max() / scale, (b - f).abs().mean() / scale,
        (ab == af).float().mean(),
        (q - f).abs().max() / scale, (q - f).abs().mean() / scale,
        (aq == af).float().mean(), (aq == ab).float().mean(),
    ]).tolist()
    keys = ("bf16_max_rel", "bf16_mean_rel", "bf16_argmax_agree", "int8_max_rel",
            "int8_mean_rel", "int8_argmax_agree", "int8_argmax_agree_vs_bf16")
    return dict(zip(keys, stats))


def run_serving_numerics(name, batch=64, image_size=224, device="cuda"):
    """Serving precision on one batch of ``default_rng(42)`` normal images in
    three precisions: float32 under ``config.parity_mode`` (the reference),
    bf16 (``to_bf16`` + ``bf16_mode``), and bf16 + ``int8_mode``; returns
    ``serving_stats`` and the batch. BatchNorm families are recalibrated
    first (``calibrated``)."""
    from jittor_mlp_tpu_torch import config

    ours, _ = calibrated(build_ours(name, device).eval(), image_size)
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((batch, 3, image_size, image_size))
                         .astype(np.float32)).to(device)
    with torch.inference_mode(), config.parity_mode():
        f32 = ours(x)
    ours.to_bf16()
    with torch.inference_mode(), config.bf16_mode():
        b16 = ours(x)
        with config.int8_mode():
            q8 = ours(x)
        return {"numerics_batch": batch, **serving_stats(f32, b16, q8)}


def run_train_throughput(name, batch=32, iters=10, image_size=224, try_remat=False,
                         device="cuda"):
    """Mixed-precision training img/s (``_train_img_s``); returns (img_s,
    remat used). A model whose plain step runs out of card memory retries
    under ``config.remat_mode()``; ``try_remat`` also measures the remat step
    when the plain one fits and reports the faster. Any other error
    propagates."""
    from jittor_mlp_tpu_torch import config

    try:
        plain = _train_img_s(name, batch, iters, image_size, device)
        if try_remat:
            with config.remat_mode():
                rem = _train_img_s(name, batch, iters, image_size, device)
            if rem > plain:
                return rem, True
        return plain, False
    except torch.cuda.OutOfMemoryError:
        pass  # retried below, once the failed step's tensors are freed
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    with config.remat_mode():
        return _train_img_s(name, batch, iters, image_size, device), True


def _train_img_s(name, batch, iters, image_size, device):
    """img/s of ``parallel.train.make_train_step`` steps: AdamW(1e-4) (optax's
    defaults: weight decay 1e-4, eps 1e-8), f32 master weights, bf16
    compute, one seeded batch with zero labels, a seeded generator for the
    drop-path sites. Timed as t(iters) − t(1), each the best of 3 runs (CUDA
    events on the card), after one warm-up step."""
    from jittor_mlp_tpu_torch.parallel.train import make_train_step

    device = torch.device(device)
    model = build_ours(name, device)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(0)
    data = {"image": torch.randn(batch, 3, image_size, image_size, generator=g, device=device),
            "label": torch.zeros(batch, dtype=torch.long, device=device)}
    gen = torch.Generator(device=device).manual_seed(1)

    def timed(k):
        best = float("inf")
        for _ in range(3):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(k):
                    loss = step(data, gen)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(k):
                    loss = step(data, gen)
                dt = time.perf_counter() - t0
            best = min(best, dt)
        if not torch.isfinite(loss).item():
            raise FloatingPointError(f"{name}: non-finite training loss")
        return best

    timed(1)
    dt = timed(iters) - timed(1)
    if dt <= 0:  # a step below the timing noise: widen the window
        iters *= 4
        dt = timed(iters) - timed(1)
    if dt <= 0:
        raise RuntimeError(f"{name}: unstable train timing (dt={dt:.4f} s)")
    return batch * (iters - 1) / dt


def _child(name, base):
    """Run one model of ``--all`` in a process of its own; its exit code."""
    cmd = [sys.executable, "-m", "jittor_mlp_tpu_torch.tools.compare", "--model", name, *base]
    return subprocess.run(cmd).returncode


def _without_model(argv):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--model":
            skip = True
        elif a != "--all" and not a.startswith("--model="):
            out.append(a)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="mlp_mixer")
    ap.add_argument("--all", action="store_true", help="run every config")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every measurement (cuda, cuda:N, or cpu)")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--skip-throughput", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="also measure mixed-precision training img/s")
    ap.add_argument("--int8", action="store_true",
                    help="also measure forward throughput under config.int8_mode "
                         "(dynamic W8A8 serving path)")
    ap.add_argument("--serving-numerics", action="store_true",
                    help="also audit bf16/int8 serving logits vs the f32 parity-mode "
                         "forward (deviation + argmax agreement)")
    ap.add_argument("--try-remat", action="store_true",
                    help="with --train: also measure the remat step and report the "
                         "faster of the two")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="append one JSON record per model to PATH")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        print("\n".join(sorted(CONFIGS)))
        return 0
    if args.all:
        if args.json:
            open(args.json, "w").close()  # the children append
        base = _without_model(argv)
        rc = 0
        for name in sorted(CONFIGS):
            code = _child(name, base)
            rc = rc or code
        return rc

    name = args.model
    kind, limit = card(args.device)
    print(f"== {name} == ({kind}, {limit})", flush=True)
    record = {"model": name, "device": str(args.device), "card": kind, "power_limit": limit}
    if not args.skip_parity:
        record.update(run_parity(name, image_size=args.image_size, device=args.device))
        status = "OK" if record["parity_ok"] else "FAIL"
        print(f"params: {record['params']:,}")
        print(f"parity (card f32 vs CPU f32): max abs {record['max_abs']:.3e}  "
              f"mean abs {record['mean_abs']:.3e}  max rel {record['max_rel']:.3e}  "
              f"of max|logit| {record['max_abs'] / max(record['out_scale'], 1e-30):.3e} "
              f"(limit {PARITY_BAND:g})  [{status}]"
              f"{'  bn recalibrated' if record['bn_recalibrated'] else ''}", flush=True)

    if not args.skip_throughput:
        fps = run_throughput(name, batch=args.batch, iters=args.iters,
                             image_size=args.image_size, device=args.device)
        record.update(fps=fps, batch=args.batch)
        print(f"throughput: {fps:,.1f} images/sec (bf16, batch {args.batch}, "
              f"{args.iters} iters)", flush=True)
        if args.int8:
            qfps = run_throughput(name, batch=args.batch, iters=args.iters,
                                  image_size=args.image_size, int8=True, device=args.device)
            record.update(int8_fps=qfps)
            print(f"int8 throughput: {qfps:,.1f} images/sec "
                  f"(dynamic W8A8, {qfps / fps:.2f}x bf16)", flush=True)

    if args.serving_numerics:
        nrec = run_serving_numerics(name, image_size=args.image_size, device=args.device)
        record.update(nrec)
        print(f"bf16 vs f32: max {nrec['bf16_max_rel']:.2e} mean {nrec['bf16_mean_rel']:.2e} "
              f"argmax {100 * nrec['bf16_argmax_agree']:.1f}%  |  int8 vs f32: max "
              f"{nrec['int8_max_rel']:.2e} argmax {100 * nrec['int8_argmax_agree']:.1f}% "
              f"(vs bf16 {100 * nrec['int8_argmax_agree_vs_bf16']:.1f}%)", flush=True)

    if args.train:
        try:
            tfps, remat = run_train_throughput(
                name, batch=args.batch, iters=max(args.iters // 2, 5),
                image_size=args.image_size, try_remat=args.try_remat, device=args.device)
            record.update(train_fps=tfps, train_batch=args.batch, train_remat=remat)
            print(f"train: {tfps:,.1f} images/sec (mixed precision, batch {args.batch}"
                  f"{', block remat' if remat else ''})", flush=True)
        except Exception as e:  # the sweep records the failure and goes on
            traceback.print_exc()
            record.update(train_error=f"{type(e).__name__}: {e}".split("\n")[0][:200])
            print(f"train: ERROR {record['train_error']}", flush=True)

    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(record) + "\n")
    return int(not record.get("parity_ok", True) or "train_error" in record)


if __name__ == "__main__":
    sys.exit(main())
