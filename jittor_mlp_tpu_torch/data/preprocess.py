"""On-device image preprocessing (counterpart of ``jittor_mlp_tpu/data/preprocess.py``).

uint8 NHWC batches are uploaded as they are (a quarter of the float32 bytes)
and converted, normalized and resized on the device they are on.
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
