"""Capture ``nnf.probe`` intermediates of a forward (counterpart of
``jittor_mlp_tpu/utils/probes.py``).

Models mark stage boundaries with ``nnf.probe(tag, x)``; ``capture`` runs
the forward once with a sink installed on the calling thread
(``nnf.probe_sink``) and returns the output and the tagged values. The
values stay on the model's device: compare them there and fetch scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import nnf


def capture(model, x, train=False, generator=None):
    """Run ``model``'s forward once on ``x`` (an NCHW tensor or array, moved
    to the model's device in its own dtype), returning ``(out, [(tag,
    value), ...])`` in execution order. ``train`` runs the train-mode
    forward, with ``generator`` as the drop-path source of a
    ``Model.stochastic`` model; the model's mode is restored after. No
    autograd graph is kept."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = x.to(model.device)
    was_training = model.training
    model.train(train)
    kwargs = {"generator": generator} if model.stochastic else {}
    try:
        with torch.no_grad(), nnf.probe_sink() as sink:
            out = model.forward(x, **kwargs)
    finally:
        model.train(was_training)
    return out, list(sink)
