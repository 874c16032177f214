"""Evaluation: top-1/top-5 accuracy of any model of the port over an
ImageFolder tree (counterpart of the JAX package's ``examples/eval.py``).

Batches stream through the host decode pipeline (``data.BatchIterator``
over ``data.ImageFolderDataset``); the upload stays uint8, and /255,
mean/std, NCHW, the cast, the forward and the top-5 run on the model's
device, so only the hit counts come back.

    python -m jittor_mlp_tpu_torch.examples.eval --model convmlp_s \
        --data-dir /path/to/val \
        [--checkpoint weights.pth | weights.npz | weights.int8.npz] [--bf16]

Synthetic smoke (no dataset needed):

    python -m jittor_mlp_tpu_torch.examples.eval --device cpu --synthetic --image-size 32

``--checkpoint``: a ``.pth``/``.pt`` torch state dict (strict), an
``.int8.npz`` (``quant.load_quantized``, dequantized to the dtype the eval
runs in) or any other ``.npz`` (``utils.serialization.load_params``); the
``.npz`` files may come from this package or from the JAX package. Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from jittor_mlp_tpu_torch.data.preprocess import normalize


def load_weights(model, path, bf16=False):
    """Load ``path`` into ``model`` by its kind (see the module docstring)."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        model.load_torch_state_dict(sd)
    elif path.endswith(".int8.npz"):
        from jittor_mlp_tpu_torch.quant import load_quantized

        # dequantize to the dtype the eval runs in
        load_quantized(model, path, dtype=torch.bfloat16 if bf16 else torch.float32)
    else:
        from jittor_mlp_tpu_torch.utils.serialization import load_params

        load_params(model, path)
    return model


def build_model(name, image_size, classes, device):
    """The factory ``name`` sized as the JAX example sizes it: the Mixer at
    patch 8, width 128, depth 6; any other through ``sized_kwargs``."""
    import jittor_mlp_tpu_torch as jt
    from jittor_mlp_tpu_torch.utils import sized_kwargs

    factory = getattr(jt, name)
    if name == "MLPMixerForImageClassification":
        kwargs = dict(image_size=image_size, patch_size=8, d_model=128, depth=6,
                      num_classes=classes)
    else:
        kwargs = sized_kwargs(factory, image_size=image_size, num_classes=classes)
    return factory(**kwargs, device=device).eval()


def evaluate(model, batches, batch, dtype, top5_out=None):
    """Top-1 and top-5 accuracy of ``model`` over ``batches`` ({'image': uint8
    NHWC, 'label': int} numpy batches of at most ``batch`` images), run in
    ``dtype`` (``preprocess.normalize`` with the ImageNet mean and std, on
    the model's device). A short batch is padded to ``batch`` with zero
    images whose rows are not counted. Returns (top1, top5, n, img_s): the
    accuracies, the images counted and images per second end to end
    (decode included).
    ``top5_out``: a list that gets each batch's (valid rows, 5) top-5
    indices."""
    dev = model.device
    hit1 = torch.zeros((), dtype=torch.int64, device=dev)
    hit5 = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in batches:
            imgs, labels = b["image"], np.asarray(b["label"], np.int64)
            valid = imgs.shape[0]
            if valid < batch:  # pad the ragged tail
                imgs = np.concatenate([imgs, np.zeros((batch - valid, *imgs.shape[1:]),
                                                      imgs.dtype)])
                labels = np.concatenate([labels, np.full(batch - valid, -1)])
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)  # uint8 upload
            y = torch.from_numpy(labels).to(dev)
            x = normalize(x).permute(0, 3, 1, 2).to(dtype)
            top5 = torch.topk(model.forward(x).float(), 5, dim=-1).indices
            hit1 += (top5[:, 0] == y).sum()
            hit5 += (top5 == y[:, None]).any(-1).sum()
            n += valid
            if top5_out is not None:
                top5_out.append(top5[:valid].cpu().numpy())
        h1, h5 = int(hit1), int(hit5)  # waits for the device
    dt = time.perf_counter() - t0
    return h1 / n, h5 / n, n, n / dt


def synthetic_batches(batch, image_size, classes, n_batches=3, seed=0):
    """``n_batches`` random uint8 batches with random labels (numpy seed)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield {"image": rng.integers(0, 255, (batch, image_size, image_size, 3),
                                     dtype=np.uint8),
               "label": rng.integers(0, classes, batch, dtype=np.int64)}


def main(argv=None):
    import jittor_mlp_tpu_torch as jt
    from jittor_mlp_tpu_torch.data import BatchIterator, ImageFolderDataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="MLPMixerForImageClassification",
                    choices=jt.FACTORIES)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)

    model = build_model(args.model, args.image_size, args.classes, args.device)
    if args.checkpoint:
        load_weights(model, args.checkpoint, bf16=args.bf16)
    if args.bf16:
        model.to_bf16()
    print(f"{args.model}: {model.param_count():,} params on {model.device}")

    if args.synthetic:
        batches = synthetic_batches(args.batch, args.image_size, args.classes)
    else:
        if not args.data_dir:
            ap.error("--data-dir required (or use --synthetic)")
        ds = ImageFolderDataset(args.data_dir, decode_size=args.image_size)
        batches = BatchIterator(ds, args.batch, shuffle=False, drop_last=False)
    top1, top5, n, img_s = evaluate(model, batches, args.batch,
                                    torch.bfloat16 if args.bf16 else torch.float32)
    print(f"top-1 {top1:.4f}  top-5 {top5:.4f}  ({n} images, {img_s:,.0f} img/s end-to-end)")
    return top1, top5, n, img_s


if __name__ == "__main__":
    main()
