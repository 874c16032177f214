"""Checkpoint loading (counterpart of ``jittor_mlp_tpu/utils/checkpoint.py``).

``load_torch_checkpoint`` reads a torch checkpoint from a local path and
unwraps the ``{'model': state_dict}`` container of the reference's
checkpoints. A path that does not exist is looked up by its file name in
the directory that ``JITTOR_MLP_TPU_CKPT_DIR`` names, as in the JAX
package. The port never downloads: a URL raises ``ValueError``.

GFNet's migration helpers: ``resize_pos_embed`` resizes a position
embedding's grid bilinearly, and ``gfnet_checkpoint_filter`` reshapes a
flattened patch-embedding weight and resizes a position embedding whose
grid differs from the model's.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch.nn import functional as F

CKPT_DIR_ENV = "JITTOR_MLP_TPU_CKPT_DIR"


def load_torch_checkpoint(path, map_location="cpu"):
    """The state dict in the torch checkpoint at ``path`` (tensors only:
    ``torch.load(weights_only=True)``)."""
    path = str(path)
    if path.startswith(("http://", "https://")):
        raise ValueError(f"{path}: the port loads checkpoints from local files only; "
                         f"download it and pass its path, or put it in ${CKPT_DIR_ENV}")
    ckpt_dir = os.environ.get(CKPT_DIR_ENV)
    if not os.path.exists(path) and ckpt_dir:
        staged = os.path.join(ckpt_dir, os.path.basename(path))
        if os.path.exists(staged):
            path = staged
    sd = torch.load(path, map_location=map_location, weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return sd


def load_pretrained(filename, map_location="cpu"):
    """A published checkpoint by file name, from ``$JITTOR_MLP_TPU_CKPT_DIR``."""
    ckpt_dir = os.environ.get(CKPT_DIR_ENV)
    path = os.path.join(ckpt_dir, filename) if ckpt_dir else None
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained weights {filename!r} not found: put the file in the directory "
            f"that ${CKPT_DIR_ENV} names (now {ckpt_dir!r}); the port does not download")
    return load_torch_checkpoint(path, map_location)


def resize_pos_embed(posemb, n_tokens_new, has_cls_token=True):
    """A (1, N, D) position embedding (tensor or array; N = a class token,
    if ``has_cls_token``, and a square grid) resized to ``n_tokens_new``
    tokens: the grid bilinearly, half-pixel centred, antialiased when it
    shrinks (what ``jax.image.resize(method="bilinear")`` does), the class
    token kept. Returns a float32 CPU tensor."""
    posemb = torch.as_tensor(np.asarray(posemb, np.float32)) if not isinstance(
        posemb, torch.Tensor) else posemb.detach().float().cpu()
    tok, grid = (posemb[:, :1], posemb[0, 1:]) if has_cls_token else (posemb[:, :0], posemb[0])
    gs_old = int(math.sqrt(grid.shape[0]))
    gs_new = int(math.sqrt(n_tokens_new - (1 if has_cls_token else 0)))
    grid = grid.reshape(1, gs_old, gs_old, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gs_new, gs_new), mode="bilinear", align_corners=False,
                         antialias=True)
    return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(1, gs_new * gs_new, -1)], 1)


def gfnet_checkpoint_filter(state_dict, model):
    """A GFNet checkpoint (``{'model': sd}`` or sd) for ``model``, as CPU
    tensors: a patch-embedding weight of fewer than 4 dims is reshaped to
    the model's (O, C, kh, kw), and a ``pos_embed`` of another shape than
    the model's is resized (``resize_pos_embed``, no class token). The
    target shapes are read from the model's state dict."""
    if "model" in state_dict:
        state_dict = state_dict["model"]
    own = model.state_dict()
    target_pe = own.get("pos_embed")
    out = {}
    for k, v in state_dict.items():
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if "patch_embed.proj.weight" in k and v.dim() < 4:
            w = own["patch_embed.proj.weight"]
            v = v.reshape(v.shape[0], -1, w.shape[2], w.shape[3])
        elif k == "pos_embed" and target_pe is not None and v.shape != target_pe.shape:
            v = resize_pos_embed(v, target_pe.shape[1], has_cls_token=False)
        out[k] = v
    return out
