"""Training recipes (counterpart of ``jittor_mlp_tpu/train_recipes.py``):
label smoothing, mixup/cutmix, EMA, LR schedules, and the recipe train step
with on-device metrics. The DeiT-style recipe every paper of the zoo trains
with:

    recipe = Recipe(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1,
                    ema_decay=0.9999)
    schedule = make_lr_schedule(base_lr=1e-3, warmup_steps=500,
                                total_steps=100_000)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = make_recipe_train_step(model, optimizer, num_classes, recipe,
                                  lr_schedule=schedule)
    state = init_recipe_state(model, optimizer, recipe=recipe)
    state, metrics = step(state, batch, generator)

Mixing draws its scalars (the mode's coin, λ, the box centre) on the host,
from uniforms of an explicit ``torch.Generator`` (``mix_draws``): torch's
Beta sampler takes no generator, so λ is the inverse regularized
incomplete beta function of a uniform. ``mix`` then applies the draws on
the images' device. The draws are split from the mix so that a caller can
apply draws made elsewhere (the tests give the port the JAX package's).
The recipe step seeds each step's mix draws from its generator's seed and
the step count (``mix_generator``; the JAX step's ``fold_in(rng, step)``),
so the step never waits on the card for them, and a resumed run mixes as
an uninterrupted one.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from scipy import special

from . import config
from .core import nnf, train_utils
from .parallel import _comm
from .parallel.mesh import axis_group, axis_index, axis_size
from .parallel.train import (_loss_and_sites, check_mesh_step, data_parallel, global_mean,
                             init_sharded, reduce_gradients)

# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def soft_cross_entropy(logits, soft_labels):
    """Mean cross-entropy against dense label distributions (mixed or
    smoothed targets), from the f32 ``log_softmax`` of ``logits``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft_labels * logp).sum(-1).mean()


def smooth_labels(labels, num_classes, smoothing=0.0):
    """One-hot float32 targets with label smoothing: on = 1 − s + s/K, off =
    s/K (``F.cross_entropy(label_smoothing=s)``'s targets)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    return onehot * (on - off) + off


# ---------------------------------------------------------------------------
# mixup / cutmix
# ---------------------------------------------------------------------------


class MixDraws(NamedTuple):
    """One batch's mix: ``shape`` (batch, height, width) it was drawn for;
    ``cutmix`` the mode; ``lam`` (float32) the weight of each sample's own
    label, and under mixup of its own image; ``box`` (y0, y1, x0, x1), the
    rows and columns cutmix takes from the partner (None under mixup)."""

    shape: tuple
    cutmix: bool
    lam: np.float32
    box: Any


def cutmix_box(height, width, lam, cy, cx):
    """The JAX ``_cutmix_mask``'s box in its float32 and int32 arithmetic:
    sides int32(f32(√(1 − λ))·h) and ·w, centred at (cy, cx), clipped to
    the image; returns ((y0, y1, x0, x1), λ corrected to the box's area,
    float32)."""
    f32 = np.float32
    ratio = np.sqrt(f32(1.0) - f32(lam))
    cut_h = int((ratio * f32(height)).astype(np.int32))
    cut_w = int((ratio * f32(width)).astype(np.int32))
    y0, y1 = (min(max(v, 0), height) for v in (cy - cut_h // 2, cy + cut_h // 2))
    x0, x1 = (min(max(v, 0), width) for v in (cx - cut_w // 2, cx + cut_w // 2))
    lam_adj = f32(1.0) - f32((y1 - y0) * (x1 - x0)) / f32(height * width)
    return (y0, y1, x0, x1), f32(lam_adj)


def draws_from(coin, lam_mix, lam_cut, cy, cx, shape, mixup_alpha, cutmix_alpha):
    """The ``MixDraws`` of scalars drawn elsewhere: the mode coin (True:
    cutmix, taken when both modes are on), mixup's λ, cutmix's λ before
    the area correction, and the box centre; ``shape`` is (batch, height,
    width). Cutmix when ``cutmix_alpha > 0`` and (``mixup_alpha <= 0`` or
    the coin says so), as the JAX ``mixup_cutmix``."""
    if cutmix_alpha > 0.0 and (mixup_alpha <= 0.0 or bool(coin)):
        box, lam = cutmix_box(shape[1], shape[2], lam_cut, cy, cx)
        return MixDraws(tuple(shape), True, lam, box)
    return MixDraws(tuple(shape), False, np.float32(lam_mix), None)


def _beta(alpha, u):
    """Beta(α, α) at uniform u (inverse CDF), float32; 1 when α <= 0."""
    return np.float32(special.betaincinv(alpha, alpha, u) if alpha > 0.0 else 1.0)


def mix_draws(generator, batch, height, width, mixup_alpha=0.8, cutmix_alpha=1.0,
              switch_prob=0.5):
    """Draw one batch's mix from five uniforms of ``generator`` (read on the
    host): the coin (cutmix with probability ``switch_prob``), mixup's and
    cutmix's λ from Beta(α, α), the box centre row and column. Returns
    ``MixDraws``, or None when both alphas are 0 (no mix). The same
    uniforms are drawn whatever the mode."""
    if mixup_alpha <= 0.0 and cutmix_alpha <= 0.0:
        return None
    u = torch.rand(5, generator=generator, dtype=torch.float64,
                   device=generator.device).tolist()
    return draws_from(u[0] < switch_prob, _beta(mixup_alpha, u[1]), _beta(cutmix_alpha, u[2]),
                      min(int(u[3] * height), height - 1), min(int(u[4] * width), width - 1),
                      (batch, height, width), mixup_alpha, cutmix_alpha)


def mix(images, soft_labels, draws, partner=None):
    """Apply ``draws`` to NCHW ``images`` and dense ``soft_labels``; each
    sample's partner is the batch reversed. Cutmix copies the partner's box;
    mixup blends λ·x + (1 − λ)·partner in float32 and casts back to the
    images' dtype; the labels blend with λ. ``draws`` None returns the
    inputs themselves. ``partner``: (images, soft labels) of each row's
    partner, row for row, for a rank's rows of a data-parallel batch (the
    global batch's draws, whose batch is the global one)."""
    if draws is None:
        return images, soft_labels
    b, _, h, w = images.shape
    if partner is None:
        partner = (images.flip(0), soft_labels.flip(0))
        drawn_for = (b, h, w)
    else:
        drawn_for = (draws.shape[0], h, w)
    if drawn_for != draws.shape:
        raise ValueError(f"draws made for (batch, height, width) {draws.shape}, "
                         f"images {tuple(images.shape)}")
    p_images, p_labels = partner
    lam = float(draws.lam)
    rest = float(np.float32(1.0) - draws.lam)  # JAX's float32 1 − λ
    if draws.cutmix:
        y0, y1, x0, x1 = draws.box
        mixed = images.clone()
        mixed[:, :, y0:y1, x0:x1] = p_images[:, :, y0:y1, x0:x1]
    else:
        mixed = (lam * images.float() + rest * p_images.float()).to(images.dtype)
    return mixed, lam * soft_labels + rest * p_labels


def partner_rows(tensor, mesh):
    """The partners of this rank's rows when the global batch pairs with
    itself reversed: rank r's rows pair with data rank (n − 1 − r)'s,
    reversed, which the two ranks exchange over the data group."""
    n, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    return _comm.exchange(tensor, n - 1 - r, axis_group(mesh, "data")).flip(0)


def mixup_cutmix(generator, images, soft_labels, mixup_alpha=0.8, cutmix_alpha=1.0,
                 switch_prob=0.5):
    """Mixup or cutmix (a coin per batch) of NCHW images and dense soft
    labels: ``mix_draws`` from ``generator``, then ``mix``. Either alpha
    at 0 turns its mode off; both at 0 return the inputs themselves.
    Returns (mixed_images, mixed_labels)."""
    b, _, h, w = images.shape
    draws = mix_draws(generator, b, h, w, mixup_alpha, cutmix_alpha, switch_prob)
    return mix(images, soft_labels, draws)


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------


def ema_update(ema, new, decay):
    """Polyak average in place, ema ← decay·ema + (1 − decay)·new in ema's
    dtype (``torch._foreach_*``); ``ema`` and ``new`` are dicts by name
    (the trainable partition: the model's parameters) or sequences in one
    order. Returns ``ema``."""
    keys = list(ema) if isinstance(ema, dict) else range(len(ema))
    e = [ema[k] for k in keys]
    p = [new[k].detach().to(t.dtype) for k, t in zip(keys, e)]
    with torch.no_grad():
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, p, alpha=1.0 - decay)
    return ema


def swap_in_ema(model, ema):
    """A state dict of ``model`` with each parameter replaced by its EMA
    (buffers as they are), copies in the model's dtypes: it loads with
    ``strict=True`` into the model, or a model like it (a ``Predictor``'s),
    for eval or export."""
    sd = model.state_dict()
    return {k: (ema[k].to(v.dtype) if k in ema else v).detach().clone() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def _linear(init, end, steps):
    """optax ``linear_schedule(init, end, steps)``."""
    def schedule(t):
        frac = 1.0 - min(max(t, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def make_lr_schedule(base_lr, total_steps, warmup_steps=0, kind="cosine", min_lr=0.0):
    """``step -> lr``: an optional linear warmup from 0 over
    ``warmup_steps``, then {cosine, linear, constant} decay from
    ``base_lr`` to ``min_lr`` over the remaining ``max(total − warmup, 1)``
    steps: optax's ``cosine_decay_schedule(base_lr, ...,
    alpha=min_lr/base_lr)``, ``linear_schedule`` and ``constant_schedule``
    joined at ``warmup_steps`` (``join_schedules``), in float64."""
    decay_steps = max(total_steps - warmup_steps, 1)
    if kind == "cosine":
        alpha = min_lr / base_lr

        def decay(t):
            cosine = 0.5 * (1.0 + math.cos(math.pi * min(t, decay_steps) / decay_steps))
            return base_lr * ((1.0 - alpha) * cosine + alpha)
    elif kind == "linear":
        decay = _linear(base_lr, min_lr, decay_steps)
    elif kind == "constant":
        def decay(t):
            return base_lr
    else:
        raise ValueError(f"unknown schedule kind {kind!r}")
    if warmup_steps <= 0:
        return decay
    warmup = _linear(0.0, base_lr, warmup_steps)
    return lambda t: warmup(t) if t < warmup_steps else decay(t - warmup_steps)


# ---------------------------------------------------------------------------
# the recipe train step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Recipe:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    ema_decay: float = 0.0  # 0 disables EMA


class RecipeState(NamedTuple):
    params: Any  # {name: the live model's parameter}
    opt_state: Any  # the optimizer
    ema: Any  # {name: EMA tensor} of the parameters, or None
    step: int


def init_recipe_state(model, optimizer, mesh=None, recipe=Recipe()):
    """The recipe state of ``model`` (its parameters, the f32 masters) and
    ``optimizer`` (built over ``model.parameters()``), with an EMA copy of
    the parameters when ``recipe.ema_decay > 0``; step 0. With ``mesh``
    the model is placed as ``parallel.train.init_sharded`` places it
    (unless a pipeline's ``init_sharded(..., stages=)`` already did), for
    ``make_recipe_train_step(..., mesh=mesh)``."""
    if mesh is not None and getattr(model, "pipeline_stages", None) is None:
        init_sharded(model, optimizer, mesh)
    params = dict(model.named_parameters())
    ema = ({k: p.detach().clone() for k, p in params.items()}
           if recipe.ema_decay > 0.0 else None)
    return RecipeState(params, optimizer, ema, 0)


def mix_generator(generator, step):
    """The CPU generator of the recipe step's mix draws at step ``step``,
    seeded from ``generator``'s seed and the step: it draws nothing from
    ``generator`` and never waits on the card."""
    seed = np.random.SeedSequence([generator.initial_seed(), step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(seed[0]))


def _grad_norm(model, mesh):
    """Global L2 norm of the f32 gradients; under a pipeline placement the
    squares of the stage-owned ones summed over the model group."""
    stages = getattr(model, "pipeline_stages", None) or {}
    grads = [p.grad.float() for k, p in model.named_parameters()
             if p.grad is not None and stages.get(k) is None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    own = [p.grad.float() for k, p in model.named_parameters()
           if p.grad is not None and stages.get(k) is not None]
    if mesh is None or not stages:
        return norm
    sq = torch.stack(torch._foreach_norm(own)).square().sum() if own else norm.new_zeros(())
    return torch.sqrt(norm.square() + _comm.all_reduce(sq, axis_group(mesh, "model")))


def make_recipe_train_step(model, optimizer, num_classes, recipe=Recipe(), compute_dtype=None,
                           bn_momentum=0.1, lr_schedule=None, mesh=None):
    """Build ``step(state, batch, generator) -> (state, metrics)``.

    ``batch``: {"image": NCHW float, "label": int labels}. Each step
    smooths the labels, mixes (``mixup_cutmix``, draws seeded from
    ``generator``'s seed and ``state.step``), takes the f32
    ``soft_cross_entropy`` through the train step's loss boundary
    (``parallel.train``: ``compute_dtype=torch.bfloat16`` casts the
    parameters, buffers and images at the boundary over f32 masters, and
    the block-kernel gates, ``config.pallas_bwd`` and
    ``config.remat_mode()`` hold as in ``make_train_step``; ``generator``,
    on the model's device, draws the drop-path masks), steps the
    optimizer and updates the EMA. ``lr_schedule`` (``step -> lr``) sets
    each parameter group's lr to ``lr_schedule(state.step)`` before the
    update, so update k runs at schedule(k), AdamW's decoupled decay
    included, and a restored ``state.step`` resumes the schedule; None
    leaves the lr to the caller.

    ``bn_momentum``: the BatchNorm running statistics take the forward's
    batch statistics of the mixed images after each update, as in
    ``make_train_step``; None leaves them as they are (the JAX recipe
    step's behaviour). Metrics are detached device scalars, read with no
    sync: ``loss``, ``accuracy`` (top-1 against the hard labels) and
    ``grad_norm`` (global L2 of the f32 gradients before the update). The
    step raises RuntimeError under ``config.int8_mode()``.

    ``mesh``: one rank's part of a data-parallel recipe step, as
    ``make_train_step(..., mesh=)`` (``batch`` holds the rank's rows; the
    loss scaled by 1 / |model group|, the gradients reduced before the
    clip-free norm and the update). The mix draws are the global batch's,
    the same on every rank, and each row's partner is its partner in the
    global batch reversed (``partner_rows``); loss and accuracy are the
    global batch's."""

    def step(state, batch, generator):
        if config.int8_enabled():  # the W8A8 path's rounding has a zero gradient
            raise RuntimeError(
                "config.int8_mode() is inference-only: the dynamic-int8 "
                "dense path has zero gradient. Exit the context before "
                "running a train step.")
        it = int(state.step)
        dev = model.device
        labels = batch["label"].to(dev)
        soft = smooth_labels(labels, num_classes, recipe.label_smoothing)
        images = batch["image"].to(dev)
        if mesh is None:
            images, soft = mixup_cutmix(mix_generator(generator, it), images, soft,
                                        recipe.mixup_alpha, recipe.cutmix_alpha,
                                        recipe.switch_prob)
            scope, scale = contextlib.nullcontext(), 1
        else:
            check_mesh_step(model, mesh, bn_momentum)
            b, _, h, w = images.shape
            draws = mix_draws(mix_generator(generator, it), b * axis_size(mesh, "data"), h, w,
                              recipe.mixup_alpha, recipe.cutmix_alpha, recipe.switch_prob)
            if draws is not None:
                images, soft = mix(images, soft, draws, (partner_rows(images, mesh),
                                                         partner_rows(soft, mesh)))
            scope, scale = data_parallel(mesh, b), axis_size(mesh, "model")
        optimizer.zero_grad(set_to_none=True)
        with nnf.bn_stats() as stats, scope:  # the forward's statistics only
            loss, logits, sites = _loss_and_sites(model, {"image": images, "label": soft},
                                                  compute_dtype, generator, soft_cross_entropy)
        (loss / scale).backward()
        if mesh is not None:
            reduce_gradients(model, mesh)
        grad_norm = _grad_norm(model, mesh)
        if lr_schedule is not None:
            lr = lr_schedule(it)
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        if bn_momentum is not None and stats:
            train_utils.apply_bn_updates(sites, stats, bn_momentum)
        if recipe.ema_decay > 0.0:
            ema_update(state.ema, dict(model.named_parameters()), recipe.ema_decay)
        accuracy = (logits.argmax(-1) == labels).float().mean()
        loss = loss.detach()
        if mesh is not None:
            loss, accuracy = global_mean(loss, mesh), global_mean(accuracy, mesh)
        metrics = {"loss": loss, "accuracy": accuracy, "grad_norm": grad_norm}
        return RecipeState(state.params, state.opt_state, state.ema, it + 1), metrics

    return step
