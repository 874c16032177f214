"""Base module with the surface of ``jittor_mlp_tpu.core.model.Model``.

A zoo model is an ``nn.Module`` whose ``state_dict`` names are the torch
reference's; the factories build it on the card by default (``place``).
``Model`` adds what the JAX facade offers on top: torch
state-dict import/export by those names, ``to_bf16``, ``param_count`` and a
``__call__`` that also takes a numpy NCHW batch and casts it to
``config.compute_dtype`` (as the JAX ``Model.__call__`` does).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import config


class Model(nn.Module):
    name = None  # zoo key, e.g. "mlp_mixer" (tuned.serve_settings looks it up)
    stochastic = False  # True: the train forward takes a drop-path `generator`

    def __init__(self):
        super().__init__()
        self.init_sd = None  # flat torch-name → numpy array, from SDBuilder

    def _load_init(self, sd):
        """Take the SDBuilder state dict as this module's parameters. The
        submodules were built on the meta device, so this is their only
        initialization (no torch RNG is drawn)."""
        self.init_sd = sd
        self.load_state_dict(
            {k: torch.from_numpy(v.copy()) for k, v in sd.items()},
            strict=True, assign=True,
        )

    def place(self, device):
        """Move the model to ``device``. The factories call this with their
        ``device`` argument ("cuda" unless the caller asks for the CPU); a
        CUDA device with no card raises instead of falling back."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: device {str(device)!r} asked for, but "
                f"torch.cuda.is_available() is false; pass device='cpu' to "
                f"build the model on the CPU")
        return self.to(device)

    @property
    def device(self):
        return next(self.parameters()).device

    # -- torch-compat surface -------------------------------------------------

    def load_torch_state_dict(self, state_dict):
        """Import a torch ``state_dict`` (tensors or ndarrays), strictly."""
        ref = self.state_dict()
        sd = {}
        for k, v in state_dict.items():
            t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            sd[k] = t.to(ref[k].device, ref[k].dtype) if k in ref else t
        self.load_state_dict(sd, strict=True)
        return self

    def export_torch_state_dict(self, tensors=True):
        """The parameters as a torch ``state_dict`` on the CPU; numpy float32
        arrays with ``tensors=False``."""
        sd = {k: v.detach().cpu() for k, v in self.state_dict().items()}
        if not tensors:
            sd = {k: v.float().numpy() for k, v in sd.items()}
        return sd

    def to_bf16(self):
        return self.to(torch.bfloat16)

    def param_count(self):
        return sum(p.numel() for p in self.parameters())

    # -- forward --------------------------------------------------------------

    def __call__(self, x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device, config.compute_dtype)
        return super().__call__(x, *args, **kwargs)
