"""Sequence (token) parallelism for Mixer and ResMLP blocks (counterpart of
``jittor_mlp_tpu/parallel/sequence.py``).

Tokens split over a mesh axis. Channel mixing is per token and needs no
communication; the token-mixing product pair of a Mixer block becomes

    t = all_reduce( W1[:, local] @ LN(x_local) )     — partial contraction
    y_local = W2[local, :] @ gelu(t + b1)            — this rank's rows

(Megatron-style 1-D parallelism over the token axis), and ResMLP's one
N × N token product a partial contraction followed by a reduce-scatter
over the output tokens. The blocks are plain PyTorch, as the JAX ones are
``jnp.einsum`` and not Pallas: no block kernel runs under these runners.
Each rank slices its columns of W1, and its rows of W2 and b2, from its
full copy of the weights, so the gradients of the slices land in the full
parameters and ``make_train_step(mesh=)`` sums them over the model group.

The runners take the whole (B, N, D) sequence from the stem, keep this
rank's tokens, run every block token-parallel, and all-gather the tokens
at the end, so the model's norm, pooling and head see the whole sequence
on every rank. ``num_patches % model_size != 0`` raises. The ``axis``
arguments keep the JAX names and take "model" only (``mesh.require_axis``):
the train step scales the loss by 1 / |model group|.
"""

from __future__ import annotations

import torch

from ..core import nnf
from . import _comm
from .mesh import axis_group, axis_index, axis_size, require_axis


def _ln(x, w, b, eps=1e-5):
    """The JAX ``_ln``: statistics and the affine in float32, cast to x's
    dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _local(mesh, axis, n):
    """This rank's token range [lo, hi) of ``n`` tokens along ``axis``."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} tokens do not split over a '{axis}' axis of {size}")
    per = n // size
    lo = axis_index(mesh, axis) * per
    return lo, lo + per


def token_parallel_mixer_block(mesh, axis="model"):
    """Build ``fn(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, w3, b3, w4,
    b4)`` running one Mixer block on this rank's tokens ``x`` (B, N/s, D)
    with the block's full weights: token w1 (TD, N), b1 (TD,), w2 (N, TD),
    b2 (N,), channel w3 (CD, D), b3, w4 (D, CD), b4."""
    require_axis(axis)
    group = axis_group(mesh, axis)

    def block(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, w3, b3, w4, b4):
        lo, hi = _local(mesh, axis, w1.shape[1])
        xn = _ln(x, ln1w, ln1b)
        t = torch.einsum("oi,bid->bod", w1[:, lo:hi], xn)  # partial over local tokens
        t = _comm.all_reduce(t, group)  # (B, TD, D) full
        t = nnf.gelu(t + b1[None, :, None])
        y = torch.einsum("oi,bid->bod", w2[lo:hi], t)  # this rank's output tokens
        h = x + y + b2[lo:hi, None]
        hn = _ln(h, ln2w, ln2b)  # channel mix: per token, no communication
        c = nnf.gelu(torch.matmul(hn, w3.t()) + b3)
        return h + torch.matmul(c, w4.t()) + b4

    return block


def dense_mixer_block(x, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b, w3, b3, w4, b4):
    """The single-device block that ``token_parallel_mixer_block`` splits,
    for agreement checks."""
    xn = _ln(x, ln1w, ln1b)
    t = nnf.gelu(torch.einsum("oi,bid->bod", w1, xn) + b1[None, :, None])
    h = x + torch.einsum("oi,bid->bod", w2, t) + b2[None, :, None]
    hn = _ln(h, ln2w, ln2b)
    c = nnf.gelu(torch.matmul(hn, w3.t()) + b3)
    return h + torch.matmul(c, w4.t()) + b4


def token_parallel_resmlp_block(mesh, axis="model"):
    """Build ``fn(x, pa, pb, g1, wt, bt, qa, qb, g2, w3, b3, w4, b4)``
    running one ResMLP block (pre-affine, + g1·token mix, post-affine, +
    g2·FF) on this rank's tokens ``x`` with the block's full weights (the
    affines flattened to (D,), wt (N, N))."""
    require_axis(axis)
    group = axis_group(mesh, axis)

    def block(x, pa, pb, g1, wt, bt, qa, qb, g2, w3, b3, w4, b4):
        lo, hi = _local(mesh, axis, wt.shape[1])
        h = x * pa + pb
        part = torch.einsum("oi,bid->bod", wt[:, lo:hi], h)  # (B, N, D) partial sums
        tm = _comm.reduce_scatter(part, group, dim=1)  # this rank's token rows
        h = h + g1 * (tm + bt[lo:hi, None])
        h = h * qa + qb
        y = nnf.gelu(torch.matmul(h, w3.t()) + b3)
        return h + g2 * (torch.matmul(y, w4.t()) + b4)

    return block


def _mixer_block_args(blk):
    """One Mixer block's (token, channel) PreNormResiduals as the 12
    weight arguments of ``token_parallel_mixer_block``."""
    tok, chan = blk
    return (*tok.fused_args(), *chan.fused_args())


_SP_FAMILIES = {
    "mlp_mixer": (token_parallel_mixer_block, _mixer_block_args),
    "res_mlp": (token_parallel_resmlp_block, lambda blk: blk.fused_args()),
}


def token_parallel_runner(mesh, family="mlp_mixer", axis="model"):
    """A ``block_runner`` running every block of ``family`` ("mlp_mixer"
    or "res_mlp") token-parallel over ``axis``:

        runner = token_parallel_runner(mesh, "res_mlp")
        model = jt.ResMLPForImageClassification(block_runner=runner)

    The per-block ``fn`` each factory passes is ignored: the runner runs
    the family's token-split block on the block's weights (cast to the
    activations' dtype). Requires num_patches % mesh axis size == 0."""
    if family not in _SP_FAMILIES:
        raise ValueError(f"token parallelism covers {sorted(_SP_FAMILIES)}, not {family!r}")
    make_block, to_args = _SP_FAMILIES[family]
    tp_block = make_block(mesh, axis)
    group = axis_group(mesh, axis)

    def runner(fn, blocks, x):
        lo, hi = _local(mesh, axis, x.shape[1])
        h = x[:, lo:hi]
        for blk in blocks:
            h = tp_block(h, *(a.to(x.dtype) for a in to_args(blk)))
        return _comm.all_gather(h, group, dim=1)

    return runner


def token_parallel_mixer_runner(mesh, axis="model"):
    """``token_parallel_runner(mesh, "mlp_mixer", axis)``."""
    return token_parallel_runner(mesh, "mlp_mixer", axis)
