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
numpy seeds (prototypes seed 0, step ``s``'s labels seed 1000 + s, as
there; the noise of row i of the batch seed (1000 + s, i), so that a rank
draws only its rows), so the loss visibly descends. With ``--data-dir`` (class subfolders of images), batches
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

Under ``torchrun --nproc-per-node=N`` (NCCL on cards, raising where there
is none; gloo with ``--device cpu``) the example joins the world
(``parallel.multihost.initialize``) and trains data-parallel over a
('data', 'model') mesh: ``--batch`` is the global batch, and each rank
makes, decodes and augments only its rows (``multihost.process_batch_size``
and ``process_batch_offset``), with the draws of the whole batch. ``--model-parallel`` sizes the
'model' axis: without ``--pipeline-stages`` it is tensor parallelism, as in
the JAX example (``parallel.init_sharded`` at the JAX ``min_dim`` of 512:
each tensor the JAX heuristic shards keeps a rank's slice, the Mixer's
channel MLPs split across the ranks, ``parallel/tensor.py``);
``--pipeline-stages P`` > 1 sets it to P and runs every block stack as a
GPipe pipeline of ``--microbatches`` microbatches (``--batch`` must divide
by it), each rank keeping its stage's blocks, with the BatchNorm running
statistics frozen (``bn_momentum=None``; refresh them with
``core.train_utils.recalibrate_bn`` afterwards). Rank 0 writes the
checkpoints: the model's and the optimizer's whole state dicts, a
pipeline's gathered from its stages and a tensor-parallel model's from its
slices (``parallel.gather_state_dict`` and ``gather_optimizer_state``), so
a checkpoint loads into a dense model and a resumed run, placed or not,
trains as an uninterrupted one.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.parallel import (gather_optimizer_state, gather_state_dict,
                                           init_sharded, make_train_step, multihost,
                                           pipeline_runner, pipeline_shardings, tensor)
from jittor_mlp_tpu_torch.parallel.mesh import check_device, mesh_device
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="size of the mesh's 'model' axis (under torchrun): tensor "
                         "parallelism unless --pipeline-stages")
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="GPipe pipeline parallelism: split each block stack into this many "
                         "stages over the 'model' axis (overrides --model-parallel)")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="microbatches streamed through the pipeline (--pipeline-stages "
                         "only; --batch must divide by it)")
    args = ap.parse_args(argv)

    pp = args.pipeline_stages
    mp = pp if pp > 1 else args.model_parallel
    if pp > 1 and args.batch % args.microbatches:
        raise SystemExit("--batch must divide by --microbatches")
    multihost.initialize(backend="gloo" if torch.device(args.device).type == "cpu" else "nccl")
    mesh = None
    rows = (0, args.batch)  # (offset, size) of this process's rows of each batch
    if dist.is_initialized():
        mesh = multihost.make_pod_mesh(model_parallel=mp)
        check_device(mesh, args.device, "--device")
        index = torch.device(args.device).index
        if index is not None and index != mesh_device(mesh).index:
            raise SystemExit(f"--device {args.device}: this rank computes on "
                             f"{mesh_device(mesh)}")
        rows = (multihost.process_batch_offset(mesh, args.batch),
                multihost.process_batch_size(mesh, args.batch))
    elif mp > 1:
        raise SystemExit("--model-parallel / --pipeline-stages > 1 run one process per "
                         "device: start the example with torchrun --nproc-per-node=N")
    rank0 = mesh is None or dist.get_rank() == 0

    factory = getattr(jt, args.model)
    if args.model == "MLPMixerForImageClassification":
        kwargs = dict(image_size=args.image_size, patch_size=8, d_model=128, depth=6,
                      num_classes=args.classes)
    else:
        kwargs = {**REQUIRED.get(args.model, {}),
                  **sized_kwargs(factory, image_size=args.image_size, num_classes=args.classes)}
    model = factory(**kwargs, device=args.device)
    if rank0:
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

    make_batch = folder_batches(args, rows) if args.data_dir else synthetic_batches(args, rows)
    logger = None
    if args.metrics and rank0:
        logger = MetricsLogger(args.metrics, extra={"model": args.model, "batch": args.batch})
    start, save = 0, None
    if args.ckpt_dir:
        if args.ckpt_every < 1:
            raise SystemExit("--ckpt-every must be >= 1")
        start, save = checkpoints(args.ckpt_dir, model, optimizer, mesh)

    # BN running-stat EMA under a pipeline: per-microbatch statistics would
    # diverge from torch's per-batch EMA; freeze the buffers (as in JAX)
    bn_momentum = 0.1
    runner_scope = contextlib.nullcontext()
    if mesh is not None:
        stages = None
        if pp > 1:
            stages = pipeline_shardings(model, mesh, (1, 3, args.image_size, args.image_size))
            runner_scope = nnf.block_runner_scope(pipeline_runner(
                mesh, microbatches=args.microbatches, data_axis="data"))
            bn_momentum = None
            if rank0:
                print(f"pipeline: {pp} stages x {args.microbatches} microbatches; BN running "
                      f"stats frozen (bn_momentum=None); refresh after training with "
                      f"train_utils.recalibrate_bn if the model uses BatchNorm")
        init_sharded(model, optimizer, mesh, stages=stages)
    step = make_train_step(model, optimizer,
                           compute_dtype=torch.bfloat16 if args.mixed_precision else None,
                           bn_momentum=bn_momentum, mesh=mesh)

    generator = torch.Generator(device=args.device)
    losses = []
    t0 = t_step = time.time()
    with config.remat_mode() if use_remat else contextlib.nullcontext(), runner_scope:
        for s in range(start, args.steps):
            generator.manual_seed(s)  # per step: a resumed run draws the same masks
            loss = step(make_batch(s), generator)
            losses.append(loss)
            if logger is not None:
                now = time.time()
                logger.log(s, loss=float(loss),
                           images_per_sec=args.batch / max(now - t_step, 1e-9))
                t_step = now
            if rank0 and (s % 10 == 0 or s == args.steps - 1):
                print(f"step {s:4d}  loss {float(loss):.4f}")
            if save is not None and ((s + 1) % args.ckpt_every == 0 or s == args.steps - 1):
                save(s + 1)
    if logger is not None:
        logger.flush()
    if rank0:
        print(f"{args.steps - start} steps in {time.time() - t0:.1f}s on {model.device}")
    return model, [float(v) for v in losses]


def synthetic_batches(args, rows):
    """make_batch(step): rows ``rows`` = (offset, size) of the step's batch
    of class prototypes plus noise (see the docstring)."""
    protos = np.random.default_rng(0).standard_normal(
        (args.classes, 3, args.image_size, args.image_size))
    off, n = rows

    def make_batch(s):
        labels = np.random.default_rng(1000 + s).integers(0, args.classes, args.batch)[off:off + n]
        noise = np.stack([np.random.default_rng((1000 + s, i)).standard_normal(
            (3, args.image_size, args.image_size)) for i in range(off, off + n)])
        imgs = protos[labels] + 0.5 * noise
        return {"image": torch.from_numpy(imgs.astype(np.float32)).to(args.device),
                "label": torch.from_numpy(labels).to(args.device)}

    return make_batch


def folder_batches(args, rows):
    """make_batch(step): rows ``rows`` = (offset, size) of the step's batch
    over ``--data-dir``, the only ones decoded, augmented with the draws of
    the whole batch. The epoch and the position in it derive from the
    step, so a resumed run starts the epoch's iterator (seed = epoch) and
    skips the batches it already took."""
    from jittor_mlp_tpu_torch.data import BatchIterator, ImageFolderDataset, make_augment

    ds = ImageFolderDataset(args.data_dir, decode_size=args.image_size + args.image_size // 8)
    augment = make_augment(image_size=args.image_size)
    per_epoch = max(len(ds) // args.batch, 1)
    stream = {"epoch": -1, "it": None, "pos": 0}

    def make_batch(s):
        epoch, pos = divmod(s, per_epoch)
        if stream["epoch"] != epoch or stream["pos"] > pos:
            stream.update(epoch=epoch, pos=0,
                          it=iter(BatchIterator(ds, args.batch, seed=epoch, rows=rows)))
        for _ in range(pos - stream["pos"]):  # resume: skip the batches already taken
            next(stream["it"])
        raw = next(stream["it"])
        stream["pos"] = pos + 1
        gen = torch.Generator(device=args.device).manual_seed(1_000_000 + s)
        return {"image": augment(gen, torch.from_numpy(raw["image"]).to(args.device),
                                 window=(args.batch, rows[0])),
                "label": torch.from_numpy(raw["label"].astype(np.int64)).to(args.device)}

    return make_batch


def checkpoints(ckpt_dir, model, optimizer, mesh=None):
    """Resume from the newest ``step_%08d`` file under ``ckpt_dir`` (made if
    missing); returns (the step to start at, save(step)). Under a mesh,
    every rank resumes from the file (before any placement) and ``save``
    writes on rank 0 only, the model's and the optimizer's state dicts
    gathered from the stages or slices."""
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
        state = opt_state = None
        if mesh is not None:
            state = gather_state_dict(model, mesh)
            if getattr(model, "pipeline_stages", None) or tensor.is_placed(model):
                opt_state = gather_optimizer_state(optimizer, model, mesh)
            if dist.get_rank() != 0:
                return
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        save_train_state(path + ".tmp", model, optimizer, step, model_state=state,
                         optimizer_state=opt_state)
        os.replace(path + ".tmp", path)  # a cut save never replaces a whole checkpoint
        for f in saved()[:-2]:  # pruned only once the new one exists
            os.remove(os.path.join(ckpt_dir, f))

    return start, save

if __name__ == "__main__":
    main()
