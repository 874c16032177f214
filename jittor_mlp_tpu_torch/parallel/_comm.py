"""Differentiable collectives on a process group: the port's counterparts of
the JAX ``psum``, ``psum_scatter`` and all-gather under ``shard_map``.

Each forward is one ``torch.distributed`` call on ``group``; each backward
is the transpose of the forward, itself one collective, so every rank of
the group must run the same calls in the same order, forward and backward
(as for any collective). A group of one rank runs the same calls, which
are then identities.

- ``all_reduce(x, group)``: Σ over the ranks; backward Σ of the
  cotangents (``psum``'s transpose is ``psum``).
- ``all_gather(x, group, dim)``: the ranks' pieces joined along ``dim`` in
  rank order; backward each rank's slice of the summed cotangent.
- ``reduce_scatter(x, group, dim)``: Σ over the ranks, this rank's slice
  along ``dim`` (``psum_scatter(tiled=True)``); backward the all-gather.
- ``exchange(x, peer, group)``: this rank's ``x`` for the ``x`` of the
  group rank ``peer`` (no gradient), on ``p2p``: one batch of a send and
  a receive, either or both, which the pipeline's hops also run on.

The reduce-scatter runs as an all-reduce and a slice, and the gathers as
``dist.all_gather`` of a list: the calls that both NCCL and gloo take in
every torch release the port meets. gloo also takes CUDA tensors for the
all-reduce, the all-gather and the broadcast (torch 2.11 on an H100: how
chip_smoke.py's phase 14 runs two ranks on one card), though not for
``p2p``'s sends and receives, which tensor parallelism does not use.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_rank(group):
    """This process's rank within ``group``."""
    return dist.get_rank(group)


def _gather(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _slice(x, group, dim):
    n = dist.get_world_size(group)
    return x.chunk(n, dim)[group_rank(group)].contiguous()


def _summed(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _summed(dy, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _slice(_summed(dy, ctx.group), ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        if x.shape[dim] % dist.get_world_size(group):
            raise ValueError(f"reduce_scatter: axis {dim} of {tuple(x.shape)} does not "
                             f"divide over {dist.get_world_size(group)} ranks")
        return _slice(_summed(x, group), group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.group, ctx.dim), None, None


def all_reduce(x, group):
    """Σ of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduce.apply(x, group)


def all_gather(x, group, dim=0):
    """The ranks' ``x`` joined along ``dim`` in rank order, differentiable."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x, group, dim=0):
    """This rank's slice along ``dim`` of Σ over the ranks, differentiable."""
    return _ReduceScatter.apply(x, group, dim)


def p2p(group, tensor=None, to=None, out=None, frm=None):
    """Send ``tensor`` to global rank ``to`` and receive into ``out`` (a
    contiguous tensor) from global rank ``frm``, either or both, in one
    batch, and wait for them."""
    ops = []
    if tensor is not None:
        ops.append(dist.P2POp(dist.isend, tensor.contiguous(), to, group))
    if out is not None:
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def exchange(x, peer, group):
    """The ``x`` of group rank ``peer``, which gets this rank's ``x`` in
    turn (shapes and dtypes equal); ``x`` itself when ``peer`` is this
    rank."""
    if peer == group_rank(group):
        return x
    src = dist.get_global_rank(group, peer) if group is not None else peer
    return p2p(group, x, src, torch.empty_like(x), src)
