"""The train step (counterpart of ``jittor_mlp_tpu/parallel/train.py``).

``make_train_step(model, optimizer, compute_dtype=None)`` returns
``step(batch, generator=None) -> loss``: one forward and backward of the
f32 cross-entropy on ``batch = {"image": (B, C, H, W), "label": (B,)}``,
then ``optimizer.step()``; the model's parameters and the optimizer's
state change in place. ``generator`` (a ``torch.Generator`` on the model's
device) is the random source of the model's drop-path sites, the JAX
step's ``rng``; without one, drop-path is the identity.

Mixed precision follows the JAX step: with ``compute_dtype=torch.bfloat16``
the master parameters, their gradients and the optimizer stay f32, and
every floating parameter and buffer, and the images, are cast at the loss
boundary (``torch.func.functional_call`` with the cast tensors), so
autograd brings f32 gradients back through the casts. In bf16 the model's
block-kernel gate picks its training kernels (``config.pallas_bwd``,
``config.remat_mode()``). Only parameters are optimized; buffers (the
JAX ``split_params`` aux leaves) are cast for the forward and never
updated. The JAX step's sharding helpers and BatchNorm running-statistic
updates are not ported: none of the ported models has BatchNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import config


def cross_entropy_loss(logits, labels):
    """Mean negative log-likelihood of ``labels`` under the f32
    ``log_softmax`` of ``logits``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def cast_floating(tensors, dtype):
    """Each floating tensor of the dict cast to ``dtype`` (others pass)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}


class _Forward(nn.Module):
    """The model's ``forward`` as a module of its own: ``Model.__call__``
    casts its input to ``config.compute_dtype``, where the train step
    hands the forward its images as they are (the JAX ``apply_fn``). A
    model with stochastic layers (``Model.stochastic``) also gets the
    generator; the others draw no random numbers and get none."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, generator=None):
        if self.model.stochastic:
            return self.model.forward(x, generator=generator)
        return self.model.forward(x)


def loss_fn(model, batch, compute_dtype=None, generator=None):
    """The f32 cross-entropy of ``model`` in train mode on ``batch``,
    differentiable in the model's parameters; with ``compute_dtype`` the
    parameters, buffers and images are cast to it at this boundary.
    ``generator`` goes to the model's drop-path sites."""
    fwd = _Forward(model.train())
    x = batch["image"].to(model.device)
    tensors = {**dict(fwd.named_parameters()), **dict(fwd.named_buffers())}
    if compute_dtype is not None:
        tensors = cast_floating(tensors, compute_dtype)
        x = x.to(compute_dtype)
    logits = torch.func.functional_call(fwd, tensors, (x,), {"generator": generator})
    return cross_entropy_loss(logits, batch["label"].to(logits.device))


def make_train_step(model, optimizer, compute_dtype=None, bn_momentum=0.1):
    """Build ``step(batch, generator=None) -> loss`` (a detached f32
    scalar) for ``model`` and ``optimizer`` (built over
    ``model.parameters()``).

    ``compute_dtype=torch.bfloat16`` gives mixed precision with f32 master
    weights (see the module docstring). ``generator`` is the random source
    of the model's drop-path sites (the JAX step's ``rng``); models without
    stochastic layers ignore it. ``bn_momentum`` keeps the JAX signature: the
    BatchNorm running-statistic update it sets waits for a model with
    BatchNorm. Raises RuntimeError under ``config.int8_mode()``."""
    del bn_momentum  # no ported model has BatchNorm

    def step(batch, generator=None):
        if config.int8_enabled():  # the W8A8 path's rounding has a zero gradient
            raise RuntimeError(
                "config.int8_mode() is inference-only: the dynamic-int8 "
                "dense path has zero gradient. Exit the context before "
                "tracing a train step.")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, compute_dtype, generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
