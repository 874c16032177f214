"""Tensor parallelism over the mesh's 'model' axis: the port's execution of
the JAX placement (``jittor_mlp_tpu/parallel/train.py``'s ``shard_params``,
which ``Model.shard`` and ``init_sharded`` apply there, and which XLA's
SPMD partitioner turns into collectives).

The placement (``place``) is the JAX one, unchanged: each tensor whose spec
(``train.shard_params``) holds "model" keeps this rank's contiguous chunk
along that axis, state-dict names unchanged, and the model records
``tp_specs`` (those tensors' specs), ``tp_shapes`` (their whole shapes),
``tp_mesh`` and ``tp_split`` (the names its family can split itself). A
model's ``state_dict()`` then holds slices; ``pipeline.gather_state_dict``
and ``gather_optimizer_state`` bring them back whole. A model is placed
once: placing it again over a mesh of another layout, or at a ``min_dim``
that gives other specs, raises.

The port has no partitioner, so each call takes one of two mechanisms for
each sharded tensor, by this rule (``boundary``, at the forward's
boundary, once a call):

- **A split**, where the family's forward has a split mode for the tensor's
  site (``Model.tensor_parallel_splits``) and that mode applies to the call
  (``Model.tensor_parallel_split_applies``): the call runs under
  ``tensor_parallel_scope`` of the model group, and the site reads this
  rank's slice and sums partial results over the group itself. The
  Mixer's channel MLP is the one such site (Megatron's: Wc1 and bc1 split
  on the hidden axis, Wc2 on its input axis, one all-reduce of the f32
  partial a block: ``split_mixer_block``). Its split mode does not apply
  under ``config.int8_mode()``, nor on the Mixer's backward-kernel route
  (``config.pallas_bwd``), where the JAX ``pallas_call`` also runs whole.
- **A gather**, for every other sharded tensor: ``gather_tp`` all-gathers
  it whole at the forward's boundary (after the train step's cast, so a
  bf16 step gathers half the bytes), differentiably, the slices of one
  dtype in one collective. Every op then runs on whole tensors, exactly:
  cuFFT, cuDNN's LSTM, the gathers and every block kernel, as XLA runs a
  ``pallas_call`` on replicated operands.

The gradients: every rank of a model group computes the same loss, scaled
by 1 / |model group| before the backward (``train._mesh_step``); the
all-gather's backward gives each rank its slice of the cotangents summed
over the group, and a split's all-reduce sums its cotangents likewise, so a
sharded tensor's gradient is whole for the rank's rows, and
``train.reduce_gradients`` sums it over the ranks holding the same slice
(the data group) where a replicated one is summed over the world.

``tensor_parallel_scope(group)`` lives in ``core.nnf``, beside the other
parallel scopes, so that a checkpointed block recomputes inside it.
``COUNTS["split"]`` counts the split sites' calls.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
import torch.distributed as dist
from torch import nn

from ..core.nnf import tensor_parallel_group, tensor_parallel_scope
from ..ops.kernels import mixer_block as mb
from . import _comm
from .mesh import axis_group, axis_index, axis_size

COUNTS = {"split": 0}
_COUNT_LOCK = threading.Lock()

__all__ = ["COUNTS", "boundary", "call", "count", "fused_mixer_block_tp",
           "fused_mixer_block_tp_trainable", "gather_tp", "is_placed", "mixer_block_plain_tp",
           "model_group", "place", "reset_counts", "split_mixer_block", "tensor_parallel_group",
           "tensor_parallel_scope"]


def count():
    """Add one to ``COUNTS["split"]`` (a split site's call that split)."""
    with _COUNT_LOCK:
        COUNTS["split"] += 1


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def is_placed(model):
    """Whether ``place`` left slices in ``model``."""
    return bool(getattr(model, "tp_specs", None))


def model_group(model):
    """The process group of the model axis ``model`` was placed over."""
    return axis_group(model.tp_mesh, "model")


def _model_ranks(mesh):
    """The global ranks of this rank's line along the mesh's 'model' axis."""
    return mesh.mesh[axis_index(mesh, "data")].tolist()


def place(model, mesh, specs, optimizer=None):
    """Keep this rank's chunk of each tensor of ``model`` whose spec in
    ``specs`` ({state-dict name: spec}, ``train.shard_params``) holds
    "model": ``t.data = t.chunk(P, axis)[rank]``, a tensor of its own. The
    optimizer's state of a placed parameter (AdamW's moments, restored
    from a checkpoint) is cut alike. Returns {name: spec} of the placed
    tensors. A model placed before is left as it is when ``mesh`` puts
    this rank in the same model group and ``specs`` places the same
    tensors alike; otherwise ValueError (its slices hold another layout)."""
    placed = {k: tuple(s) for k, s in specs.items() if "model" in s}
    if is_placed(model):
        if _model_ranks(mesh) != _model_ranks(model.tp_mesh) or placed != model.tp_specs:
            raise ValueError(
                f"the model is placed over the model group {_model_ranks(model.tp_mesh)} "
                f"with {len(model.tp_specs)} tensors sharded; this mesh's model group is "
                f"{_model_ranks(mesh)} with {len(placed)}: gather its state "
                f"(pipeline.gather_state_dict) into a model built anew, and place that")
        return model.tp_specs
    size, rank = axis_size(mesh, "model"), axis_index(mesh, "model")
    tensors = model.state_dict(keep_vars=True)
    state = optimizer.state if optimizer is not None else {}
    shapes = {}
    for name, spec in placed.items():
        t, axis = tensors[name], spec.index("model")
        if t.shape[axis] % size:  # _leaf_spec places only axes P divides
            raise AssertionError(f"{name}: axis {axis} of {tuple(t.shape)} does not split "
                                 f"over {size} ranks")
        shapes[name] = tuple(t.shape)
        for k, v in state.get(t, {}).items():
            if isinstance(v, torch.Tensor) and tuple(v.shape) == shapes[name]:
                state[t][k] = v.chunk(size, axis)[rank].clone()
        t.data = t.data.chunk(size, axis)[rank].clone()
    model.tp_specs, model.tp_shapes, model.tp_mesh = placed, shapes, mesh
    model.tp_split = frozenset(model.tensor_parallel_splits(placed)) if placed else frozenset()
    return placed


def gather_tp(tensors, specs, group):
    """``tensors`` ({name: tensor}) with each one whose spec in ``specs``
    holds "model" all-gathered whole along that axis over ``group``. The
    slices of one dtype, device and ``requires_grad`` go flat into one
    bucket and one ``_comm.all_gather`` (its backward: this rank's slice of
    the cotangent summed over the group), and each whole tensor is cut back
    out of the gathered bucket."""
    out = dict(tensors)
    buckets = {}
    for name, spec in specs.items():
        if name in out and "model" in spec:
            t = out[name]
            buckets.setdefault((t.dtype, t.device, t.requires_grad), []).append(name)
    size = dist.get_world_size(group)
    for names in buckets.values():
        flat = torch.cat([out[n].reshape(-1) for n in names])
        whole = _comm.all_gather(flat, group, 0).view(size, -1)
        off = 0
        for n in names:
            t, axis = out[n], specs[n].index("model")
            ranks = whole[:, off:off + t.numel()].reshape(size, *t.shape)
            out[n] = ranks.movedim(0, axis).flatten(axis, axis + 1)  # rank r's chunk r
            off += t.numel()
    return out


def boundary(model, tensors, x, prefix=""):
    """(tensors, scope) for one call of ``model`` on the input ``x``:
    ``tensors`` (named as its state dict, with ``prefix``) with every placed
    tensor that the call does not split gathered whole, and the context to
    run the call in (``tensor_parallel_scope`` of the model group where a
    split applies); by the rule in the module docstring. For a model not
    placed: ``tensors`` as they are and a null context."""
    if not is_placed(model):
        return tensors, contextlib.nullcontext()
    split = model.tp_split if model.tensor_parallel_split_applies(x) else frozenset()
    group = model_group(model)
    specs = {prefix + k: s for k, s in model.tp_specs.items() if k not in split}
    scope = tensor_parallel_scope(group) if split else contextlib.nullcontext()
    return gather_tp(tensors, specs, group), scope


class _Apply(nn.Module):
    """``model.forward`` as a module, so that ``functional_call`` binds
    the gathered tensors for one call."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.forward(*args, **kwargs)


def call(model, x, *args, **kwargs):
    """``model.forward(x, *args, **kwargs)`` of a placed model, through
    ``boundary``. Every rank of the model group calls it alike (it runs
    collectives)."""
    app = _Apply(model)
    tensors = {**dict(app.named_parameters()), **dict(app.named_buffers())}
    tensors, scope = boundary(model, tensors, x, prefix="model.")
    with scope:
        return torch.func.functional_call(app, tensors, (x, *args), kwargs)


# -- the Mixer block with its channel MLP split over the hidden axis ---------


def split_mixer_block(x, weights, reduce, plain=False):
    """One Mixer block whose channel MLP is this rank's slice (``weights``:
    ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b whole, wc1 (CD_r, D), bc1
    (CD_r,), wc2 (D, CD_r), bc2 whole): this rank's (h, f32 partial), then
    ``reduce(partial)``, the sum of the ranks' partials (an all-reduce over
    the model group; a caller holding every rank's partial in one process
    sums them itself), then the finish with bc2 and the residual. The
    kernel ops (``mb.PARTIAL_OP``, ``mb.FINISH_OP``: the CUDA entry and
    pass on a CUDA tensor, their twins on a CPU one), or with ``plain``
    ``mixer_block_plain``'s pieces."""
    if plain:
        partial, finish = mb.mixer_block_plain_partial, mb.mixer_block_plain_finish
    else:
        mb.check_block_input(x, "mixer-block")
        mb.block_dims(x, weights)
        partial, finish = mb.PARTIAL_OP, mb.FINISH_OP
    h, p = partial(x, *weights[:-1])
    return finish(h, reduce(p), weights[-1])


def _all_reduce(group):
    """Σ over ``group`` (None: one rank, the partial itself)."""
    return (lambda p: p) if group is None else functools.partial(_comm.all_reduce, group=group)


def fused_mixer_block_tp(x, *weights, group=None):
    """``split_mixer_block`` through the kernel ops, the partials summed
    over ``group``. On a CUDA tensor it raises on anything the kernels do
    not take and never falls back."""
    return split_mixer_block(x, weights, _all_reduce(group))


def mixer_block_plain_tp(x, *weights, group=None):
    """``mixer_block_plain`` with its channel MLP split over ``group``
    (``split_mixer_block`` on the plain pieces; the all-reduce is
    differentiable)."""
    return split_mixer_block(x, weights, _all_reduce(group), plain=True)


def fused_mixer_block_tp_trainable(x, *weights, group=None):
    """Differentiable split block: ``fused_mixer_block_tp`` forward,
    autograd of ``mixer_block_plain_tp`` backward (the recompute route;
    the backward's all-reduce is ``_comm``'s)."""
    return mb.KernelForwardPlainBackward.apply(
        functools.partial(fused_mixer_block_tp, group=group),
        functools.partial(mixer_block_plain_tp, group=group), x, *weights)
