"""Checkpoint loading (counterpart of ``jittor_mlp_tpu/utils/checkpoint.py``).

``load_torch_checkpoint`` reads a torch checkpoint from a local path and
unwraps the ``{'model': state_dict}`` container of the reference's
checkpoints. A path that does not exist is looked up by its file name in
the directory that ``JITTOR_MLP_TPU_CKPT_DIR`` names, as in the JAX
package. The port never downloads: a URL raises ``ValueError``.
"""

from __future__ import annotations

import os

import torch

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
