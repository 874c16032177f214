"""Where the forward's time goes on the card: torch.profiler over the
serving paths at batch 256.

    python -m jittor_mlp_tpu_torch.tools.profile_blocks [--batch 256] [--iters 3]

For Mixer-B/16 (d_model 768, depth 12, token_dim 384), ResMLP-S24
(d_model 384, depth 24) and gMLP-S @224 (d_model 256, d_ffn 1536,
depth 30) in bf16 and int8, it profiles ``iters`` forwards
after a warm-up and prints each CUDA kernel's device time per forward,
its share of the device time, the device-busy share of the wall time,
and the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import torch

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch import config

MODELS = {
    "Mixer-B/16": (jt.MLPMixerForImageClassification, dict(d_model=768, depth=12, token_dim=384)),
    "ResMLP-S24": (jt.ResMLPForImageClassification, dict(d_model=384, depth=24)),
    "gMLP-S": (jt.gMLPForImageClassification,
               dict(image_size=224, d_model=256, d_ffn=1536, depth=30)),
}


def _device_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def profile(model, x, int8, iters):
    ctx = config.int8_mode if int8 else contextlib.nullcontext
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), ctx():
        model.forward(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model.forward(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU ops that launched them carry the
    # same time again
    rows = [(e.key, _device_us(e) / 1e3 / iters, e.count // iters)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    return sorted(rows, key=lambda r: -r[1]), wall_ms / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_blocks needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    x = torch.randn(args.batch, 3, 224, 224, device="cuda").bfloat16()
    for name, (factory, kw) in MODELS.items():
        model = factory(**kw).to_bf16().eval()
        for int8 in (False, True):
            rows, wall = profile(model, x, int8, args.iters)
            busy = sum(r[1] for r in rows)
            print(f"\n{name} b{args.batch} {'int8' if int8 else 'bf16'}: wall {wall:.3f} ms "
                  f"per forward, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
            print(f"  {'ms/fwd':>9} {'share':>6} {'calls':>5}  kernel")
            for key, ms, calls in rows[:14]:
                print(f"  {ms:9.4f} {100 * ms / busy:5.1f}% {calls:5d}  {key[:110]}")
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
