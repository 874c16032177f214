"""create_model walkthrough for the port (counterpart of the repository's
``examples/create_model.py``, the reference's create_model.ipynb as a
script).

Builds each exported factory at its default (paper) config on ``--device``
(the card by default), runs a forward on a seeded normal batch, and prints
the parameter count, the forward FLOPs per image (``Model.flops``: the
products and convolutions, 2·M·N·K each) and the output shape; ``--time``
adds the milliseconds of one forward, by CUDA events on the card. Run from
the repository root:

    python -m jittor_mlp_tpu_torch.examples.create_model                 # every factory
    python -m jittor_mlp_tpu_torch.examples.create_model --model ViP     # one factory
    python -m jittor_mlp_tpu_torch.examples.create_model --device cpu --batch 2
    python -m jittor_mlp_tpu_torch.examples.create_model --time

A factory that fails is printed and counted, and the exit code is then 1.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# every exported factory at its default (paper) config, as in the notebook
FACTORIES = [
    "MLPMixerForImageClassification",
    "gMLPForImageClassification",
    "ResMLPForImageClassification",
    "ViP",
    "S2MLPv1_deep",
    "S2MLPv1_wide",
    "S2MLPv2",
    "ConvMixer",
    "convmlp_s",
    "convmlp_m",
    "convmlp_l",
    "RaftMLP",
    "SparseMLP",
    "HireMLP",
    "GFNet",
    "GFNetPyramid",
    "CycleMLP_B1",
    "CycleMLP_B2",
    "CycleMLP_B3",
    "CycleMLP_B4",
    "CycleMLP_B5",
    "AS_MLP",
    "SwinMLP",
    "create_RepMLPNet_B224",
    "create_RepMLPNet_B256",
    "WaveMLP",
    "MS_MLP",
    "MorphMLP",
    "DynaMixer",
    "ActiveSmall",
    "ActiveBase",
    "ActiveLarge",
    "Sequencer2D",
]

# factories whose defaults need a kwarg to build standalone (the configs the
# notebook passes explicitly)
KWARGS = {
    "gMLPForImageClassification": dict(image_size=224),
    "ViP": dict(patch_size=14, segments=16),
    "ConvMixer": dict(dim=768, depth=32, kernel_size=7, patch_size=7),
    "RaftMLP": dict(layers=[
        {"depth": 2, "dim": 64, "patch_size": 4, "raft_size": 2},
        {"depth": 2, "dim": 128, "patch_size": 2, "raft_size": 2},
    ]),
    "WaveMLP": dict(model_name="T"),
    "MorphMLP": dict(model_name="T"),
    "DynaMixer": dict(model_name="T"),
    "Sequencer2D": dict(model_name="S"),
}

# factories hard-wired to a non-224 resolution
INPUT_SIZE = {"create_RepMLPNet_B256": 256}

TIMED = 10  # timed forwards, after 3 warm-up ones


def forward_ms(model, x):
    """Milliseconds of one forward of ``x``: the mean of TIMED after 3
    warm-up ones (CUDA events on the card, the host clock on the CPU)."""
    for _ in range(3):
        model(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED):
            model(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / TIMED
    t0 = time.perf_counter()
    for _ in range(TIMED):
        model(x)
    return 1e3 * (time.perf_counter() - t0) / TIMED


def row(name, batch=8, image_size=224, device="cuda", timed=False):
    """(params, FLOPs per image, output shape, ms per forward or None) of
    factory ``name`` at its default config, on a batch from default_rng(0)."""
    import jittor_mlp_tpu_torch as jt

    size = INPUT_SIZE.get(name, image_size)
    model = getattr(jt, name)(**KWARGS.get(name, {}), device=device).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, 3, size, size)).astype(np.float32)).to(device)
    with torch.inference_mode():
        out = model(x)
        ms = forward_ms(model, x) if timed else None
    return model.param_count(), model.flops((1, 3, size, size)), tuple(out.shape), ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="one factory name")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--time", action="store_true",
                    help="also time a forward (CUDA events on the card)")
    args = ap.parse_args(argv)

    names = [args.model] if args.model else FACTORIES
    where = torch.device(args.device)
    kind = torch.cuda.get_device_name(where) if where.type == "cuda" else "cpu"
    print(f"device: {args.device} ({kind})   batch: {args.batch}")
    header = f"{'factory':34s} {'params':>12s} {'GFLOPs/img':>10s} {'output':>12s}"
    print(header + ("   ms/fwd" if args.time else ""))
    print("-" * len(header))

    failures = 0
    for name in names:
        try:
            params, flops, shape, ms = row(name, args.batch, args.image_size, args.device,
                                           args.time)
            line = f"{name:34s} {params:>12,} {flops / 1e9:>10.2f} {str(shape):>12s}"
            if ms is not None:
                line += f"   {ms:6.2f}"
            print(line, flush=True)
        except Exception as e:  # keep walking the zoo, as the notebook does
            failures += 1
            print(f"{name:34s} ERROR {type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
