"""BatchNorm running-statistic recalibration (counterpart of
``jittor_mlp_tpu/core/train_utils.py::recalibrate_bn``).

``recalibrate_bn(model, batches)`` runs one train-mode forward per batch,
collects every BatchNorm site's batch statistics through ``nnf.bn_stats()``
and writes, per site, the mean of the batch means and the mean of the
biased batch variances into ``running_mean`` and ``running_var``. A site is
named by its ``running_mean`` tensor, so no site tagging is needed. The
train-mode forward itself updates no buffer (``nnf.batch_norm`` is pure).

The running-statistic EMA of a train step (the JAX ``apply_bn_updates`` and
``execution_order_ids``) is not ported.
"""

from __future__ import annotations

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
                for rm, mean, var in sink:
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
