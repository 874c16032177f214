"""Ahead-of-time model export (counterpart of ``jittor_mlp_tpu/deploy.py``).

``export_forward`` traces a model's eval forward once, at one fixed NCHW
shape, with ``torch.export`` and returns the ``ExportedProgram`` (the graph
with the weights); ``save_exported`` / ``load_exported`` round-trip it
through ``torch.export.save`` / ``load``, so a server runs the model from
one file, without the model's code or a checkpoint to import.

    deploy.save_exported(model, "mixer_b16.pt2", batch_size=8)
    ...
    fwd = deploy.load_exported("mixer_b16.pt2")
    logits = fwd(images)          # (8, 3, 224, 224) -> (8, 1000)

The block kernels are registered ``torch.library`` ops
(``ops/kernels/_op.py``), so each kernel call is one node of the graph and
launches the kernel when the program runs on the card. Loading therefore
needs this package importable (``load_exported`` imports it), where the
JAX package's blob needs only ``jax``. Exports are fixed-shape, as the JAX
ones: another shape raises.

What the trace reads once, at export: ``config.int8_enabled()`` (thread
local; ``int8=True`` traces under ``config.int8_mode()``, which bakes the
W8A8 block kernels and dense ops into the program), the input's dtype and
device (the block kernels' gates) and the model's eval mode.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from . import config
from .parallel.train import _Forward


def export_forward(model, batch_size=8, image_size=224, in_channels=3,
                   dtype=torch.float32, int8=False):
    """Trace the eval forward of ``model`` into an ``ExportedProgram`` with
    its weights, for an NCHW input ``(batch_size, in_channels, image_size,
    image_size)`` of ``dtype`` on the model's device. ``int8=True`` traces
    under ``config.int8_mode()`` (dynamic W8A8: in bf16, the W8A8 block
    kernels)."""
    model.eval()  # _Forward: the forward as it stands (Model.__call__ would cast x)
    x = torch.zeros((batch_size, in_channels, image_size, image_size), dtype=dtype,
                    device=model.device)
    with config.int8_mode() if int8 else nullcontext():
        return torch.export.export(_Forward(model), (x,))


def save_exported(model, path, **kwargs):
    """``torch.export.save`` of ``export_forward(model, **kwargs)`` to
    ``path``; returns ``path``."""
    torch.export.save(export_forward(model, **kwargs), path)
    return path


def input_spec(program):
    """(shape, dtype, device) of an exported program's input."""
    from torch.export.graph_signature import InputKind

    (name,) = [s.arg.name for s in program.graph_signature.input_specs
               if s.kind == InputKind.USER_INPUT]
    val = next(n for n in program.graph.nodes if n.name == name).meta["val"]
    return tuple(val.shape), val.dtype, val.device


def load_exported(path):
    """Load a ``save_exported`` file; returns ``fwd(x) -> logits``, which
    casts ``x`` (a tensor or a numpy array) to the exported dtype and device
    and accepts exactly the exported shape (another one raises); it runs
    under ``torch.inference_mode()``. Importing
    this module imports the package, which registers the kernel ops the
    program calls."""
    program = torch.export.load(path)
    shape, dtype, device = input_spec(program)
    module = program.module()

    def fwd(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        if tuple(x.shape) != shape:
            raise ValueError(f"input shape {tuple(x.shape)} != the exported {shape}")
        with torch.inference_mode():
            return module(x.to(device, dtype))

    fwd.program = program
    return fwd
