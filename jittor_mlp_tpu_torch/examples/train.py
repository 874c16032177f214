"""Train a model of the port on synthetic class-separable data or an image folder.

    python -m jittor_mlp_tpu_torch.examples.train --model MLPMixerForImageClassification \
        --image-size 64 --batch 64 --steps 50 [--mixed-precision] [--remat on] \
        [--data-dir /path/to/train] [--metrics m.jsonl] [--ckpt-dir ckpt --ckpt-every 25]

``--model`` is any factory the package exports, sized to ``--image-size``
and ``--classes`` through ``utils.sized_kwargs`` as the JAX example does
(a factory with no image-size argument, as CycleMLP or ConvMixer, takes
its own defaults and any image size its stem accepts); the Mixer keeps
the example's small configuration (patch 8, width 128, depth 6), and the
two factories whose widths have no default take compare.py's:
ConvMixer-768/32 and RaftMLP's two levels of 64 and 128.

Without ``--data-dir``, the synthetic path of the JAX package's
``examples/train.py``: one random prototype image per class, and each
step's batch is the prototypes of its labels plus 0.5·N(0, 1) noise, from
numpy seeds (prototypes seed 0, step ``s`` seed 1000 + s), so the loss
visibly descends. With ``--data-dir`` (class subfolders of images), batches
come from ``data.ImageFolderDataset`` decoded at image_size + image_size/8
through ``BatchIterator`` (reshuffled each epoch with seed = epoch) and
``make_augment`` (random crop and flip on the device, from a generator
seeded 1,000,000 + step). AdamW with decay 1e-4 and eps 1e-8 (optax
``adamw``'s defaults). ``--mixed-precision`` trains in bf16 with f32
master weights; in bf16 the blocks run in the hand-written kernels
(``config.pallas_bwd`` picks the Mixer's backward). Drop-path draws from a
generator seeded with the step (the JAX example's ``fold_in(rng, step)``);
BatchNorm running statistics update every step.

``--metrics`` appends one JSON line per step (loss, images/s; a meta line
with the model and batch first) through ``utils.metrics.MetricsLogger``.
``--ckpt-dir`` saves ``utils.serialization.save_train_state`` files
``step_%08d`` every ``--ckpt-every`` steps and at the end, each written to
a temporary name and renamed into place, the older ones pruned to the last
two after the new one exists; a run resumes from the newest. The batch
stream, the augmentation and drop-path all derive from the step, so a
resumed run trains on what an uninterrupted one would. Runs on the card
unless ``--device cpu``; ``main`` returns the model and the step losses.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import time

import numpy as np
import torch

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.parallel import make_train_step
from jittor_mlp_tpu_torch.tuned import train_settings
from jittor_mlp_tpu_torch.utils import sized_kwargs
from jittor_mlp_tpu_torch.utils.metrics import MetricsLogger
from jittor_mlp_tpu_torch.utils.serialization import restore_train_state, save_train_state

MODELS = jt.FACTORIES
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
    ap.add_argument("--data-dir", default=None,
                    help="ImageFolder-style dataset root (default: synthetic)")
    ap.add_argument("--metrics", default=None,
                    help="append per-step JSON metrics to this .jsonl file")
    ap.add_argument("--ckpt-dir", default=None,
                    help="train-state dir: save every --ckpt-every steps and resume from it")
    ap.add_argument("--ckpt-every", type=int, default=25)
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

    make_batch = folder_batches(args) if args.data_dir else synthetic_batches(args)
    logger = None
    if args.metrics:
        logger = MetricsLogger(args.metrics, extra={"model": args.model, "batch": args.batch})
    start, save = 0, None
    if args.ckpt_dir:
        if args.ckpt_every < 1:
            raise SystemExit("--ckpt-every must be >= 1")
        start, save = checkpoints(args.ckpt_dir, model, optimizer)

    generator = torch.Generator(device=args.device)
    losses = []
    t0 = t_step = time.time()
    with config.remat_mode() if use_remat else contextlib.nullcontext():
        for s in range(start, args.steps):
            generator.manual_seed(s)  # per step: a resumed run draws the same masks
            loss = step(make_batch(s), generator)
            losses.append(loss)
            if logger is not None:
                now = time.time()
                logger.log(s, loss=float(loss),
                           images_per_sec=args.batch / max(now - t_step, 1e-9))
                t_step = now
            if s % 10 == 0 or s == args.steps - 1:
                print(f"step {s:4d}  loss {float(loss):.4f}")
            if save is not None and ((s + 1) % args.ckpt_every == 0 or s == args.steps - 1):
                save(s + 1)
    if logger is not None:
        logger.flush()
    print(f"{args.steps - start} steps in {time.time() - t0:.1f}s on {model.device}")
    return model, [float(v) for v in losses]


def synthetic_batches(args):
    """make_batch(step) on class prototypes plus noise (see the docstring)."""
    protos = np.random.default_rng(0).standard_normal(
        (args.classes, 3, args.image_size, args.image_size))

    def make_batch(s):
        rs = np.random.default_rng(1000 + s)
        labels = rs.integers(0, args.classes, args.batch)
        imgs = protos[labels] + 0.5 * rs.standard_normal(
            (args.batch, 3, args.image_size, args.image_size))
        return {"image": torch.from_numpy(imgs.astype(np.float32)).to(args.device),
                "label": torch.from_numpy(labels).to(args.device)}

    return make_batch


def folder_batches(args):
    """make_batch(step) over ``--data-dir``. The epoch and the position in it
    derive from the step, so a resumed run starts the epoch's iterator
    (seed = epoch) and skips the batches it already took."""
    from jittor_mlp_tpu_torch.data import BatchIterator, ImageFolderDataset, make_augment

    ds = ImageFolderDataset(args.data_dir, decode_size=args.image_size + args.image_size // 8)
    augment = make_augment(image_size=args.image_size)
    per_epoch = max(len(ds) // args.batch, 1)
    stream = {"epoch": -1, "it": None, "pos": 0}

    def make_batch(s):
        epoch, pos = divmod(s, per_epoch)
        if stream["epoch"] != epoch or stream["pos"] > pos:
            stream.update(epoch=epoch, it=iter(BatchIterator(ds, args.batch, seed=epoch)), pos=0)
        for _ in range(pos - stream["pos"]):  # resume: skip the batches already taken
            next(stream["it"])
        raw = next(stream["it"])
        stream["pos"] = pos + 1
        gen = torch.Generator(device=args.device).manual_seed(1_000_000 + s)
        return {"image": augment(gen, torch.from_numpy(raw["image"]).to(args.device)),
                "label": torch.from_numpy(raw["label"].astype(np.int64)).to(args.device)}

    return make_batch


def checkpoints(ckpt_dir, model, optimizer):
    """Resume from the newest ``step_%08d`` file under ``ckpt_dir`` (made if
    missing); returns (the step to start at, save(step))."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)

    def saved():
        return sorted(f for f in os.listdir(ckpt_dir) if re.fullmatch(r"step_\d{8}", f))

    start = 0
    if saved():
        latest = os.path.join(ckpt_dir, saved()[-1])
        start = restore_train_state(latest, model, optimizer)
        print(f"resumed from {latest} at step {start}")

    def save(step):
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        save_train_state(path + ".tmp", model, optimizer, step)
        os.replace(path + ".tmp", path)  # a cut save never replaces a whole checkpoint
        for f in saved()[:-2]:  # pruned only once the new one exists
            os.remove(os.path.join(ckpt_dir, f))

    return start, save

if __name__ == "__main__":
    main()
