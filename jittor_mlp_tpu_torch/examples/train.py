"""Train a model of the port on synthetic class-separable data.

    python -m jittor_mlp_tpu_torch.examples.train --model MLPMixerForImageClassification \
        --image-size 64 --batch 64 --steps 50 [--mixed-precision] [--remat on]

``--model`` is any factory the package exports, sized to ``--image-size``
and ``--classes`` through ``utils.sized_kwargs`` as the JAX example does
(a factory with no image-size argument, as CycleMLP or ConvMixer, takes
its own defaults and any image size its stem accepts); the Mixer keeps
the example's small configuration (patch 8, width 128, depth 6), and the
two factories whose widths have no default take compare.py's:
ConvMixer-768/32 and RaftMLP's two levels of 64 and 128.

The synthetic path of the JAX package's ``examples/train.py``: one random
prototype image per class, and each step's batch is the prototypes of its
labels plus 0.5·N(0, 1) noise, from numpy seeds (prototypes seed 0, step
``s`` seed 1000 + s), so the loss visibly descends. AdamW with decay 1e-4
and eps 1e-8 (optax ``adamw``'s defaults). ``--mixed-precision`` trains
in bf16 with f32 master weights; in bf16 the blocks run in the
hand-written kernels (``config.pallas_bwd`` picks the Mixer's backward).
Drop-path draws from a generator seeded with 0 (the JAX example's
``PRNGKey(0)``); BatchNorm running statistics update every step. Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.parallel import make_train_step
from jittor_mlp_tpu_torch.tuned import train_settings
from jittor_mlp_tpu_torch.utils import sized_kwargs

MODELS = tuple(n for n in jt.__all__ if n not in ("Model", "MicroBatcher", "Predictor", "config"))
REQUIRED = {  # compare.py's widths for the factories that have none by default
    "ConvMixer": dict(dim=768, depth=32, kernel_size=7, patch_size=7),
    "RaftMLP": dict(layers=[{"depth": 2, "dim": 64, "patch_size": 4, "raft_size": 2},
                            {"depth": 2, "dim": 128, "patch_size": 2, "raft_size": 2}]),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="MLPMixerForImageClassification", choices=MODELS)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mixed-precision", action="store_true",
                    help="bf16 forward/backward, f32 master weights")
    ap.add_argument("--remat", choices=["auto", "on", "off"], default="auto",
                    help="block rematerialization: 'auto' uses the measured best-known "
                         "setting for this model (jittor_mlp_tpu_torch.tuned; off when "
                         "there is none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    factory = getattr(jt, args.model)
    if args.model == "MLPMixerForImageClassification":
        kwargs = dict(image_size=args.image_size, patch_size=8, d_model=128, depth=6,
                      num_classes=args.classes)
    else:
        kwargs = {**REQUIRED.get(args.model, {}),
                  **sized_kwargs(factory, image_size=args.image_size, num_classes=args.classes)}
    model = factory(**kwargs, device=args.device)
    print(f"{args.model}: {model.param_count():,} params on {model.device}")

    if args.remat == "auto":
        ts = train_settings(args.model)
        use_remat = bool(ts and ts["remat"])
        if ts:
            print(f"remat: {'on' if use_remat else 'off'} (measured best, "
                  f"{ts['img_s']:,.0f} img/s at b{ts['batch']})")
    else:
        use_remat = args.remat == "on"

    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, optimizer,
                           compute_dtype=torch.bfloat16 if args.mixed_precision else None)

    rng = np.random.default_rng(0)
    protos = rng.standard_normal((args.classes, 3, args.image_size, args.image_size))

    def make_batch(s):
        rs = np.random.default_rng(1000 + s)
        labels = rs.integers(0, args.classes, args.batch)
        imgs = protos[labels] + 0.5 * rs.standard_normal(
            (args.batch, 3, args.image_size, args.image_size))
        return {"image": torch.from_numpy(imgs.astype(np.float32)).to(args.device),
                "label": torch.from_numpy(labels).to(args.device)}

    generator = torch.Generator(device=args.device).manual_seed(0)
    t0 = time.time()
    with config.remat_mode() if use_remat else contextlib.nullcontext():
        for s in range(args.steps):
            loss = step(make_batch(s), generator)
            if s % 10 == 0 or s == args.steps - 1:
                print(f"step {s:4d}  loss {float(loss):.4f}")
    print(f"{args.steps} steps in {time.time() - t0:.1f}s on {model.device}")


if __name__ == "__main__":
    main()
