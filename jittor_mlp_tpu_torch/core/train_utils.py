"""BatchNorm running statistics (counterpart of
``jittor_mlp_tpu/core/train_utils.py``): recalibration and the train
step's EMA.

``recalibrate_bn(model, batches)`` runs one train-mode forward per batch,
collects every BatchNorm site's batch statistics through ``nnf.bn_stats()``
and writes, per site, the mean of the batch means and the mean of the
biased batch variances into ``running_mean`` and ``running_var``. A site is
named by its ``running_mean`` tensor, so no site tagging is needed. The
train-mode forward itself updates no buffer (``nnf.batch_norm`` is pure).

``apply_bn_updates(sites, stats, momentum)`` is the train step's EMA (the
JAX ``apply_bn_updates``), torch's train-mode BatchNorm update. A site is
named by the running_mean tensor the forward read, so the JAX
``tag_bn_sites`` and ``execution_order_ids`` (which number the sites of a
params tree for a jitted step) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nnf


def recalibrate_bn(model, batches):
    """Refresh ``running_mean`` / ``running_var`` of every BatchNorm of
    ``model`` from ``batches`` (NCHW arrays or tensors); returns the model,
    in the train or eval mode it had."""
    sites = {id(m.running_mean): m for m in model.modules()
             if getattr(m, "running_mean", None) is not None}
    if not sites:
        return model
    sums, counts = {}, {}
    was_training = model.training
    model.train()
    try:
        with torch.no_grad():
            for xb in batches:
                with nnf.bn_stats() as sink:
                    model(xb)
                for rm, mean, var, _n in sink:
                    acc = sums.setdefault(id(rm), [0.0, 0.0])
                    acc[0] = acc[0] + mean
                    acc[1] = acc[1] + var
                    counts[id(rm)] = counts.get(id(rm), 0) + 1
    finally:
        model.train(was_training)
    with torch.no_grad():
        for key, (mean, var) in sums.items():
            m = sites[key]
            m.running_mean.copy_(mean / counts[key])
            m.running_var.copy_(var / counts[key])
    return model


def apply_bn_updates(sites, stats, momentum=0.1):
    """Fold one forward's batch statistics into the running statistics, in
    place, as the JAX ``apply_bn_updates`` and torch's train-mode
    BatchNorm do:

        running_mean ← (1 − m)·running_mean + m·batch_mean
        running_var  ← (1 − m)·running_var  + m·batch_var·n/(n − 1)

    with m = ``momentum``, the biased batch variance made unbiased (n − 1
    at least 1), in float32, under ``no_grad``. ``stats``: the
    ``nnf.bn_stats()`` entries (running_mean as read, mean, var, n) of the
    forward; ``sites``: {id of the running_mean tensor the forward read:
    (the model's own running_mean, running_var[, part])}, so that a
    forward that read cast copies (a bf16 step) updates the float32
    buffers. ``part`` (axis, ranks, rank), where not None, says that the
    buffers are this rank's slice of a tensor-parallel placement
    (``parallel/tensor.py``) while the forward read them gathered whole:
    the slice takes its chunk of the statistics. A site the forward ran
    twice takes its last statistics, as in JAX.
    ``num_batches_tracked`` is left as it is: the JAX package keeps no
    counter, and a fixed momentum never reads it."""
    last = {id(rm): (mean, var, n) for rm, mean, var, n in stats}
    with torch.no_grad():
        for key, (mean, var, n) in last.items():
            rm, rv, *part = sites[key]
            if part and part[0] is not None:
                axis, ranks, rank = part[0]
                mean, var = mean.chunk(ranks, axis)[rank], var.chunk(ranks, axis)[rank]
            ratio = float(np.float32(n) / np.float32(max(n - 1, 1)))  # JAX's float32 n/(n-1)
            rm.copy_(((1.0 - momentum) * rm.float() + momentum * mean.float()).to(rm.dtype))
            rv.copy_(((1.0 - momentum) * rv.float() + momentum * (var.float() * ratio))
                     .to(rv.dtype))
