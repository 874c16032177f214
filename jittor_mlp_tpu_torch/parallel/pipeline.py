"""Pipeline parallelism over a model's block stacks, GPipe-style
(counterpart of ``jittor_mlp_tpu/parallel/pipeline.py``).

Stage d of the mesh's 'model' axis owns blocks ``[d·L/P, (d+1)·L/P)`` of
each stack of L blocks (L % P == 0), and M microbatches stream through the
stages in the classic M + P − 1 step schedule: at step t stage d runs
microbatch t − d if there is one, and bubble steps skip the compute. Each
stage's compute is the model's own per-block function over its blocks (so
the block kernels run inside stages, on microbatches of B / M rows), under
the sample window of its microbatch (``nnf.sample_window_scope``), so that
drop-path draws the dense step's bits. Activations hop from stage d to
d + 1 through a differentiable point-to-point exchange (``_Hop``, whose
backward sends each cotangent back a stage: the transpose of JAX's
``ppermute``). A token threaded through every hop makes each rank run
every hop's backward in reverse step order, bubble steps included, so the
backward's exchanges pair up; it starts from the stack's input, so that
the backward of an earlier stack's collectives runs on every rank. The
last stage's outputs reach every rank of the model group through a
differentiable all-reduce of the masked outputs (JAX's ``psum``).

    runner = pipeline_runner(mesh, microbatches=4, data_axis="data")
    model = jt.MLPMixerForImageClassification(block_runner=runner)
    stages = pipeline_shardings(model, mesh, (1, 3, 224, 224))
    init_sharded(model, optimizer, mesh, stages=stages)
    step = make_train_step(model, optimizer, mesh=mesh)

Data parallelism composes through the outer sample window: under
``make_train_step(mesh=)`` or ``Model.shard`` each rank runs its own rows,
and the microbatch windows nest in theirs. ``pipeline_shardings`` gives
each block tensor its owning stage, and ``init_sharded(..., stages=)``
releases the blocks of other stages, so a rank keeps 1/P of the blocks;
``gather_state_dict`` brings the whole state dict back to every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import nnf
from . import _comm
from .mesh import axis_group, axis_index, axis_size, require_axis


class _Hop(torch.autograd.Function):
    """One schedule step's exchange: send ``y`` to the next stage if
    ``send``, receive the previous stage's into a tensor like ``y`` if
    ``recv`` (zeros otherwise). Backward: the received tensor's cotangent
    goes back to the previous stage and ``y``'s comes from the next. The
    token passes through, so that the hops' backwards run in a chain."""

    @staticmethod
    def forward(ctx, y, token, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        out = _zeros(y)
        _comm.p2p(group, y if send is not None else None, send,
                  out if recv is not None else None, recv)
        return out, token.clone()

    @staticmethod
    def backward(ctx, d_out, d_token):
        dy = _zeros(d_out)
        _comm.p2p(ctx.group, d_out if ctx.recv is not None else None, ctx.recv,
                  dy if ctx.send is not None else None, ctx.send)
        return dy, d_token, None, None, None


def _zeros(t):
    """Contiguous zeros like ``t`` (a receive buffer must be contiguous,
    whatever the layout of the activations)."""
    return torch.zeros(t.shape, dtype=t.dtype, device=t.device)


class _Tie(torch.autograd.Function):
    """A zero token that depends on the stack's input: every rank's stack
    output then depends on its input, so the backward reaches the
    collectives before the stack (an earlier stack's broadcast) on every
    rank, with a zero cotangent where this stage does not read the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, d_token):
        return d_token.new_zeros(ctx.shape, dtype=ctx.dtype)


class _Broadcast(torch.autograd.Function):
    """Σ of the masked outputs over the model group, the token's gradient
    zero: the token chain ends here, so each rank's backward reaches every
    hop."""

    @staticmethod
    def forward(ctx, outs, token, group):
        ctx.group = group
        return _comm._summed(outs, group)

    @staticmethod
    def backward(ctx, dy):
        return _comm._summed(dy, ctx.group), dy.new_zeros(()), None


def _window_base(x, mesh, data_axis):
    """(global batch, offset) of ``x``'s rows: the active sample window, or
    without one this rank's rows of a batch split over ``data_axis`` (the
    whole batch when None)."""
    win = nnf.sample_window()
    if win is not None:
        return win
    if data_axis is None:
        return x.shape[0], 0
    n = axis_size(mesh, data_axis)
    return x.shape[0] * n, x.shape[0] * axis_index(mesh, data_axis)


def _check_axes(axis, data_axis):
    require_axis(axis)
    if data_axis is not None:
        require_axis(data_axis, "data")


def pipeline_blocks(mesh, fn, axis="model", data_axis=None):
    """Build ``run(blocks, x)`` running ``blocks`` (a stack, run as
    ``x = fn(block, x)``) as a P-stage pipeline over mesh axis ``axis``.
    ``x``: (M, mb, ...) microbatches; every rank of the model group gets
    the (M, mb, ...) outputs. ``axis`` must be "model" and ``data_axis``
    None or "data" (``mesh.require_axis``)."""
    _check_axes(axis, data_axis)
    n_stages = axis_size(mesh, axis)
    stage = axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    ranks = [dist.get_global_rank(group, i) for i in range(n_stages)]

    def run(blocks, x):
        L = len(blocks)
        if L % n_stages:
            raise ValueError(f"a stack of {L} blocks does not split into {n_stages} "
                             f"pipeline stages")
        per = L // n_stages
        own = list(blocks)[stage * per:(stage + 1) * per]
        M, mb = x.shape[0], x.shape[1]
        global_b, base = _window_base(x.reshape(M * mb, *x.shape[2:]), mesh, data_axis)
        if x.requires_grad and torch.is_grad_enabled():
            token = _Tie.apply(x)
        else:
            token = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
        recv = _zeros(x[0])
        outs = [None] * M
        for t in range(M + n_stages - 1):
            m = t - stage
            if 0 <= m < M:
                h = x[m] if stage == 0 else recv
                with nnf.sample_window_scope(global_b, base + m * mb):
                    for blk in own:
                        h = fn(blk, h)
                y = h
                if stage == n_stages - 1:
                    outs[m] = y
            else:
                y = _zeros(x[0])
            if t == M + n_stages - 2:
                break  # the last step's output goes nowhere
            send = ranks[stage + 1] if stage < n_stages - 1 and 0 <= m < M else None
            prev = t - (stage - 1)
            frm = ranks[stage - 1] if stage > 0 and 0 <= prev < M else None
            recv, token = _Hop.apply(y, token, send, frm, group)
        if stage == n_stages - 1:
            out = torch.stack(outs)
        else:
            out = _zeros(x)
        return _Broadcast.apply(out, token, group)

    return run


def pipeline_runner(mesh, microbatches, axis="model", data_axis=None):
    """A ``block_runner`` (a factory's ``block_runner=``, or
    ``nnf.block_runner_scope``) running every block stack as a pipeline:
    the batch splits into ``microbatches`` equal microbatches (B %
    microbatches == 0) that stream through the stages, and the outputs
    join again. ``data_axis``: the mesh axis the batch is split over; a
    rank's rows and their offset come from the active sample window
    (``make_train_step(mesh=)``, ``Model.shard``), or without one from
    the rank's index along ``data_axis``. ``axis`` must be "model" and
    ``data_axis`` None or "data"."""
    _check_axes(axis, data_axis)

    def runner(fn, blocks, x):
        B = x.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        xmb = x.reshape(microbatches, B // microbatches, *x.shape[1:])
        y = pipeline_blocks(mesh, fn, axis=axis, data_axis=data_axis)(blocks, xmb)
        return y.reshape(B, *y.shape[2:])

    return runner


class _Recorder:
    """A runner that runs each stack in place and records it."""

    def __init__(self):
        self.stacks = []

    def __call__(self, fn, blocks, x):
        self.stacks.append(blocks)
        for blk in blocks:
            x = fn(blk, x)
        return x


def pipeline_shardings(model, mesh, input_shape, axis="model"):
    """{name: owning stage, or None (replicated)} of each parameter and
    buffer of ``model`` under a pipeline over ``axis`` (the JAX
    ``pipeline_shardings``): a tensor of block i of a stack of L blocks
    belongs to stage i // (L/P); stems, heads and the transitions between
    stacks replicate. The stacks are the ones ``nnf.run_blocks`` receives
    in one eval forward of zeros of ``input_shape`` (one image is enough),
    with any runner replaced by a recorder. ``axis`` must be "model"."""
    require_axis(axis)
    n_stages = axis_size(mesh, axis)
    rec = _Recorder()
    runner, model.block_runner = model.block_runner, rec
    was_training = model.training
    try:
        dtype = next(p.dtype for p in model.parameters() if p.is_floating_point())
        with torch.no_grad(), nnf.block_runner_scope(rec):
            model.eval().forward(torch.zeros(input_shape, dtype=dtype, device=model.device))
    finally:
        model.block_runner = runner
        model.train(was_training)
    owner = {}
    for blocks in rec.stacks:
        L = len(blocks)
        if L % n_stages:
            raise ValueError(f"a stack of {L} blocks does not split into {n_stages} stages")
        for i, blk in enumerate(blocks):
            for t in (*blk.parameters(), *blk.buffers()):
                owner[id(t)] = i // (L // n_stages)
    return {name: owner.get(id(t)) for name, t in model.state_dict(keep_vars=True).items()}


def gather_state_dict(model, mesh, axis="model"):
    """The whole torch state dict of a model placed with
    ``init_sharded(..., stages=)`` or over a 'model' axis (tensor
    parallelism, ``parallel/tensor.py``), on every rank (a collective over
    the model group: each released tensor comes from the rank of its
    stage, each tensor-parallel slice is all-gathered along its axis).
    Tensors on the model's device; the model keeps its placement.
    ``axis`` must be "model"."""
    require_axis(axis)
    released = getattr(model, "released", {})
    stages = getattr(model, "pipeline_stages", {})
    sliced = getattr(model, "tp_specs", None) or {}
    group = axis_group(mesh, axis)
    sd = {}
    for name, t in model.state_dict().items():
        where = stages.get(name)
        if name in sliced:
            sd[name] = _comm._gather(t, group, sliced[name].index("model"))
            continue
        if where is None:
            sd[name] = t
            continue
        if name in released:
            shape, dtype = released[name]
            t = torch.empty(shape, dtype=dtype, device=model.device)
        else:
            t = t.clone()
        dist.broadcast(t, src=dist.get_global_rank(group, where), group=group)
        sd[name] = t
    return sd



def gather_optimizer_state(optimizer, model, mesh, axis="model"):
    """The whole ``optimizer.state_dict()`` of a model placed with
    ``init_sharded(..., stages=)`` or over a 'model' axis, on every rank (a
    collective over the model group): the state of each block parameter
    (AdamW's step and moments) comes from the rank of its stage, as
    ``gather_state_dict`` brings its weights; a tensor-parallel slice's
    moments are all-gathered along its axis (its step is every rank's);
    the replicated parameters' is the rank's own. Loaded before
    ``init_sharded`` places the model again, it resumes every rank's
    state. ``axis`` must be "model"."""
    require_axis(axis)
    sd = optimizer.state_dict()
    stages = getattr(model, "pipeline_stages", {})
    sliced = getattr(model, "tp_specs", None) or {}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    group = axis_group(mesh, axis)
    for i, p in enumerate(params):
        spec = sliced.get(names.get(id(p)))
        if spec is not None and i in sd["state"]:
            sd["state"][i] = {
                k: (_comm._gather(v.to(p.device), group, spec.index("model")).to(v.device)
                    if isinstance(v, torch.Tensor) and v.shape == p.shape else v)
                for k, v in sd["state"][i].items()}
    where = [stages.get(names.get(id(p))) for p in params]
    if not stages:
        return sd
    stage = axis_index(mesh, axis)
    own = {i: {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in sd["state"][i].items()}
           for i, w in enumerate(where) if w == stage and i in sd["state"]}
    layouts = [None] * axis_size(mesh, axis)
    dist.all_gather_object(layouts, own, group=group)  # what each stage holds
    for i, w in enumerate(where):
        if w is None:
            continue
        entry = {}
        for k, (shape, dtype, dev) in layouts[w].get(i, {}).items():
            t = (sd["state"][i][k].to(model.device, copy=True) if w == stage
                 else torch.empty(shape, dtype=dtype, device=model.device))
            dist.broadcast(t, src=dist.get_global_rank(group, w), group=group)
            entry[k] = t.to(dev)
        if entry:
            sd["state"][i] = entry
        else:
            sd["state"].pop(i, None)
    return sd
