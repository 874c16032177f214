"""On-device image preprocessing (counterpart of ``jittor_mlp_tpu/data/preprocess.py``).

uint8 NHWC batches are uploaded as they are (a quarter of the float32 bytes)
and converted, normalized and resized on the device they are on.
``make_preprocess`` chains the steps into one function (plain PyTorch on the
tensor's device; the JAX package jit-compiles it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_bilinear(x, size):
    """x: (B, H, W, C) any dtype → (B, size, size, C) float32, half-pixel
    centers, antialiased when shrinking (the semantics of
    ``jax.image.resize(method="bilinear")``)."""
    s = (size, size) if isinstance(size, int) else tuple(size)
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=s, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def normalize(x, mean=IMAGENET_MEAN, std=IMAGENET_STD, scale=1.0 / 255.0):
    """uint8/float (B, H, W, C) → standardized float32: (x*scale - mean) / std."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x.float() * scale - mean) / std


def patchify(x, patch_size):
    """(B, H, W, C) → (B, H/p * W/p, p*p*C) token sequence."""
    p = patch_size
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def make_preprocess(image_size=224, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                    dtype=torch.float32, layout="NCHW"):
    """uint8-HWC-batch → model-input pipeline.

    Returns fn(batch_u8: (B, H, W, 3) uint8 tensor) → (B, 3, S, S) (or NHWC)
    ``dtype`` on the batch's device. Resizes only when the input size
    differs."""

    def pipeline(batch):
        x = batch
        if x.shape[1] != image_size or x.shape[2] != image_size:
            x = resize_bilinear(x, image_size)
        x = normalize(x, mean, std)
        if layout == "NCHW":
            x = x.permute(0, 3, 1, 2)
        return x.to(dtype)

    return pipeline
