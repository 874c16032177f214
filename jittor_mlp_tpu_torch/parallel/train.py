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
JAX ``split_params`` aux leaves) are cast for the forward and not
trained.

BatchNorm running statistics update every step with torch's train-mode
EMA, as in the JAX step: the forward (and only the forward: a checkpointed
block's recompute in the backward adds nothing) reports each site's batch
statistics to ``nnf.bn_stats()``, and after ``optimizer.step()``
``train_utils.apply_bn_updates`` folds them into the model's float32
buffers, each site found by the tensor the forward read (in bf16, its
cast copy). ``bn_momentum=None`` leaves them as they are.

With ``mesh=`` (``parallel.mesh.make_mesh``) the step is one rank's part of
a data-parallel step, the port's counterpart of the JAX step over
'data'-sharded inputs, where XLA inserted the collectives that this step
writes itself. ``batch`` holds the rank's rows (``batch_sharding``): the
forward runs under the sample window of those rows (drop-path takes each
row's bit of the global draw) and BatchNorm takes the statistics of the
global batch over the data group. The loss is scaled by 1 / |model
group| before ``backward()``: every rank of a model group computes the
same loss (on the pipeline's broadcast outputs, the token-parallel
runner's gathered tokens, or a replicated model), and the backward of
their collectives sums the cotangents of all of them. Then each gradient
is summed over the ranks that hold its parameter in one flattened bucket
(the world; a pipeline stage's blocks over the data group) and divided by
|data group|, and the optimizer steps. The step returns the mean loss of
the global batch.

The placement helpers are the JAX ones on torch state-dict names:
``_leaf_spec`` and ``shard_params`` give the JAX heuristic's spec per
tensor; ``init_sharded`` and ``Model.shard`` check that nothing would be
sharded over a 'model' axis larger than 1 (tensor parallelism is not
ported: NotImplementedError names the tensors) and, with a pipeline's
``stages``, release the blocks of other stages. The JAX ``split_params``
and ``merge_params`` split a params pytree into its trainable and aux
leaves; a torch module keeps that split itself, as its parameters and its
buffers, so they have no counterpart here.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from .. import config
from ..core import nnf, train_utils
from . import _comm
from .mesh import axis_group, axis_index, axis_size, check_device, mesh_device
from .multihost import process_batch_offset, process_batch_size


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


def _loss_and_sites(model, batch, compute_dtype, generator, loss=cross_entropy_loss):
    """``loss(logits, batch["label"])`` of the model in train mode on
    ``batch`` (``loss_fn``'s loss by default), the logits, and {id of each
    running_mean tensor the forward reads: (the model's running_mean,
    running_var)} for ``train_utils.apply_bn_updates``. The train steps'
    one loss boundary: the recipe step passes its soft cross-entropy and
    soft labels."""
    fwd = _Forward(model.train())
    x = batch["image"].to(model.device)
    buffers = dict(fwd.named_buffers())
    tensors = {**dict(fwd.named_parameters()), **buffers}
    if compute_dtype is not None:
        tensors = cast_floating(tensors, compute_dtype)
        x = x.to(compute_dtype)
    sites = {id(tensors[k]): (buffers[k], buffers[k[:-len("mean")] + "var"])
             for k in buffers if k.endswith("running_mean")}
    logits = torch.func.functional_call(fwd, tensors, (x,), {"generator": generator})
    return loss(logits, batch["label"].to(logits.device)), logits, sites


def loss_fn(model, batch, compute_dtype=None, generator=None):
    """The f32 cross-entropy of ``model`` in train mode on ``batch``,
    differentiable in the model's parameters; with ``compute_dtype`` the
    parameters, buffers and images are cast to it at this boundary.
    ``generator`` goes to the model's drop-path sites."""
    return _loss_and_sites(model, batch, compute_dtype, generator)[0]


def _has_batch_norm(model):
    return any(k.endswith("running_mean") for k, _ in model.named_buffers())


def _runner_active(model):
    return nnf.block_runner() is not None or getattr(model, "block_runner", None) is not None


BN_UNDER_RUNNER = (
    "BatchNorm running-stat updates are not supported under a "
    "block runner (pipeline/SP scope). Train with "
    "make_train_step(..., bn_momentum=None) and refresh stats "
    "afterwards with train_utils.recalibrate_bn outside the "
    "scope.")


def make_train_step(model, optimizer, compute_dtype=None, bn_momentum=0.1, mesh=None):
    """Build ``step(batch, generator=None) -> loss`` (a detached f32
    scalar) for ``model`` and ``optimizer`` (built over
    ``model.parameters()``).

    ``compute_dtype=torch.bfloat16`` gives mixed precision with f32 master
    weights (see the module docstring). ``generator`` is the random source
    of the model's drop-path sites (the JAX step's ``rng``); models without
    stochastic layers ignore it. ``bn_momentum``: the momentum of the
    BatchNorm running-statistic EMA applied after each optimizer step
    (None: no update). ``mesh``: the rank's part of a data-parallel step
    over the mesh, ``batch`` holding its rows (see the module docstring);
    with a block runner active (a factory's ``block_runner=`` or
    ``nnf.block_runner_scope``) and BatchNorm running statistics to
    update, the step raises RuntimeError, as the JAX step does. The step
    raises RuntimeError under ``config.int8_mode()``."""

    def step(batch, generator=None):
        if config.int8_enabled():  # the W8A8 path's rounding has a zero gradient
            raise RuntimeError(
                "config.int8_mode() is inference-only: the dynamic-int8 "
                "dense path has zero gradient. Exit the context before "
                "tracing a train step.")
        if mesh is None:
            return _dense_step(model, optimizer, batch, compute_dtype, generator, bn_momentum)
        return _mesh_step(model, optimizer, batch, compute_dtype, generator, bn_momentum, mesh)

    return step


def _dense_step(model, optimizer, batch, compute_dtype, generator, bn_momentum):
    optimizer.zero_grad(set_to_none=True)
    with nnf.bn_stats() as stats:  # the forward's statistics only
        loss, _, sites = _loss_and_sites(model, batch, compute_dtype, generator)
    loss.backward()
    optimizer.step()
    if bn_momentum is not None and stats:
        train_utils.apply_bn_updates(sites, stats, bn_momentum)
    return loss.detach()


@contextlib.contextmanager
def data_parallel(mesh, rows):
    """The scopes of a rank's ``rows`` rows of a data-parallel batch: the
    sample window of its rows within the global batch, and BatchNorm
    statistics over the data group."""
    global_rows = rows * axis_size(mesh, "data")
    with nnf.sample_window_scope(global_rows, process_batch_offset(mesh, global_rows)), \
            nnf.batch_group_scope(axis_group(mesh, "data")):
        yield


def check_mesh_step(model, mesh, bn_momentum):
    """The mesh step's preconditions: the model on the mesh's device type,
    and no BatchNorm EMA under a block runner (the JAX RuntimeError)."""
    check_device(mesh, model.device)
    if bn_momentum is not None and _runner_active(model) and _has_batch_norm(model):
        raise RuntimeError(BN_UNDER_RUNNER)


def _mesh_step(model, optimizer, batch, compute_dtype, generator, bn_momentum, mesh):
    """One rank's part of the data-parallel step: the forward under
    ``data_parallel``, the loss scaled by 1 / |model group|,
    ``reduce_gradients``, the optimizer step and the BatchNorm EMA of the
    global statistics. Returns the global mean loss."""
    check_mesh_step(model, mesh, bn_momentum)
    optimizer.zero_grad(set_to_none=True)
    with nnf.bn_stats() as stats, data_parallel(mesh, batch["image"].shape[0]):
        value, _, sites = _loss_and_sites(model, batch, compute_dtype, generator)
    (value / axis_size(mesh, "model")).backward()
    reduce_gradients(model, mesh)
    optimizer.step()
    if bn_momentum is not None and stats:
        train_utils.apply_bn_updates(sites, stats, bn_momentum)
    return global_mean(value.detach(), mesh)


def global_mean(value, mesh):
    """The mean over the data group of a per-rank mean (of equal shares)."""
    return _comm.all_reduce(value, axis_group(mesh, "data")) / axis_size(mesh, "data")


def reduce_gradients(model, mesh):
    """Sum each parameter's gradient over the ranks that hold it and divide
    by |data group|: the replicated parameters over the world, the blocks
    of this rank's pipeline stage (``init_sharded(..., stages=)``) over its
    data group, each set in one flattened float32 bucket, reduced and
    divided in place, whose slices become the gradients. A parameter no
    rank took a gradient for keeps ``grad = None`` (the optimizer skips
    it, as the dense step's): which ones, the ranks agree on once for each
    pattern of local gradients (one small all-reduce that waits for the
    card), kept in ``model.grad_flags``, so that a step in a pattern seen
    before does not wait."""
    stages = getattr(model, "pipeline_stages", None) or {}
    stage = axis_index(mesh, "model")
    world, own = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        where = stages.get(name)
        if where is None:
            world.append(p)
        elif where == stage:
            own.append(p)
    n_data = axis_size(mesh, "data")
    known = model.__dict__.setdefault("grad_flags", {})
    for part, params, group in (("world", world, None), ("own", own, axis_group(mesh, "data"))):
        if not params:
            continue
        local = tuple(p.grad is not None for p in params)
        flags = known.get((part, local))
        if flags is None:
            summed = _comm._summed(torch.tensor(local, dtype=torch.float32,
                                                device=params[0].device), group)
            flags = known[(part, local)] = tuple(v > 0 for v in summed.tolist())
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .reshape(-1).float() for p in params])
        dist.all_reduce(flat, group=group)
        flat.div_(n_data)
        off = 0
        for p, flag in zip(params, flags):
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).to(p.dtype) if flag else None
            off += n


# -- placement (the JAX sharding helpers) -------------------------------------


def _leaf_spec(x, model_size, min_dim=512):
    """The JAX ``_leaf_spec`` on a shape (or a tensor's): the largest
    trailing axis divisible by ``model_size`` and at least ``min_dim`` goes
    on 'model' (a 1-d leaf: its only axis; a leading stacked-layer axis
    never); a tuple of one entry per axis, "model" or None; all None when
    ``model_size`` is 1."""
    shape = tuple(getattr(x, "shape", x))
    if not shape:
        return ()
    best_axis, best = None, min_dim - 1
    for axis in range(len(shape) - 1, 0, -1) if len(shape) > 1 else [0]:
        d = shape[axis]
        if d % model_size == 0 and d > best:
            best_axis, best = axis, d
    spec = [None] * len(shape)
    if best_axis is not None and model_size > 1:
        spec[best_axis] = "model"
    return tuple(spec)


def _stack_depths(module):
    """{name prefix "list.i.": depth of the list} for the blocks of each
    ``nn.ModuleList`` of ``module``: a JAX stacked params subtree, whose
    leaves carry a leading layer axis of that depth."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, nn.ModuleList):
            for i in range(len(m)):
                out[f"{name}.{i}." if name else f"{i}."] = len(m)
    return out


def shard_params(params, mesh, min_dim=512):
    """{name: spec} of the JAX ``shard_params`` heuristic for ``params``, a
    module (its parameters and buffers) or {name: tensor or shape}, under
    ``mesh`` (or the size of its 'model' axis). A tensor of a block of an
    ``nn.ModuleList`` stack is judged at its JAX shape, with the stack's
    depth in front, and that axis dropped from its spec."""
    model_size = mesh if isinstance(mesh, int) else axis_size(mesh, "model")
    stacks = {}
    if isinstance(params, nn.Module):
        stacks = _stack_depths(params)
        params = dict(params.state_dict(keep_vars=True))
    out = {}
    for name, t in params.items():
        shape = tuple(getattr(t, "shape", t))
        depth = max(((len(k), d) for k, d in stacks.items() if name.startswith(k)),
                    default=(0, None))[1]
        if depth is None:
            out[name] = _leaf_spec(shape, model_size, min_dim)
        else:
            out[name] = _leaf_spec((depth, *shape), model_size, min_dim)[1:]
    return out


def check_replicated(model, mesh, min_dim=512):
    """``shard_params`` of ``model``; NotImplementedError naming the
    tensors it would shard over 'model' (tensor parallelism is not
    ported), else the specs. A model whose 'model' axis carries a block
    runner (pipeline stages, token shards) passes: the heuristic is not
    its placement."""
    specs = shard_params(model, mesh, min_dim)
    if _runner_active(model) or getattr(model, "pipeline_stages", None):
        return specs
    tp = sorted(k for k, spec in specs.items() if "model" in spec)
    if tp:
        raise NotImplementedError(
            f"tensor parallelism is not ported: at min_dim={min_dim} a 'model' axis of "
            f"{axis_size(mesh, 'model')} would shard {len(tp)} tensors ({', '.join(tp[:6])}"
            f"{', ...' if len(tp) > 6 else ''}); raise min_dim, or give the 'model' axis to "
            f"a pipeline or token-parallel runner")
    return specs


def batch_sharding(mesh):
    """``shard(batch) -> batch``: this rank's rows of each tensor of a
    global batch dict (``multihost.process_batch_size`` rows at
    ``process_batch_offset``), on its device."""
    dev = mesh_device(mesh)

    def shard(batch):
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            n, off = process_batch_size(mesh, v.shape[0]), process_batch_offset(mesh, v.shape[0])
            out[k] = v[off:off + n].to(dev)
        return out

    return shard


def init_sharded(model, optimizer, mesh, min_dim=512, stages=None):
    """Place ``model`` (built alike on every rank, from one seed) on
    ``mesh`` for ``make_train_step(..., mesh=mesh)``. Without ``stages`` it
    must be replicated, as ``Model.shard`` checks (``check_replicated``).
    With ``stages`` (``pipeline.pipeline_shardings``) each parameter and
    buffer of another stage's blocks leaves the device (an empty tensor
    takes its place, ``pipeline.gather_state_dict`` brings the whole
    state back) and the model records ``pipeline_stages``. The
    ``optimizer`` keeps its parameters and drops its state of the
    released ones (``pipeline.gather_optimizer_state`` brings the whole
    state back). Returns (model, optimizer, the specs or stages)."""
    check_device(mesh, model.device)
    if stages is None:
        return model, optimizer, check_replicated(model, mesh, min_dim)
    stage = axis_index(mesh, "model")
    shapes = {}
    for name, t in model.state_dict(keep_vars=True).items():
        where = stages.get(name)
        if where is not None and where != stage:
            shapes[name] = (tuple(t.shape), t.dtype)
            t.data = t.data.new_empty(0)
            if optimizer is not None:
                optimizer.state.pop(t, None)
    model.pipeline_stages = dict(stages)
    model.released = shapes
    return model, optimizer, stages
