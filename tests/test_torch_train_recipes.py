"""The port's training recipes against jittor_mlp_tpu's, on the CPU.

- Losses: ``smooth_labels`` and ``soft_cross_entropy`` against the JAX
  functions and ``F.cross_entropy(label_smoothing=0.1)``, within 1e-6.
- Mixing: the scalars JAX's key sequence draws (recomputed here with
  public ``jax.random`` calls, as ``mixup_cutmix`` and ``_cutmix_mask``
  split their keys) fed to the port's ``mix`` through ``draws_from``: the
  images equal the JAX ``mixup_cutmix``'s bit for bit in f32, the labels
  within 1e-7, in both modes, each mode alone and the both-zero identity.
  The port's own draws: reproducible from a seed, mean λ ≈ 0.5, the coin's
  rate ≈ ``switch_prob``, each box's area matching its corrected λ.
- Schedules: every kind, with and without warmup, read from a real
  ``torch.optim.AdamW``'s lr after each recipe update 0..total+5, within
  1e-6 relative of the JAX (optax) schedule; a save and restore in the
  middle continues the schedule, and the parameters.
- EMA: ``ema_update`` against JAX's; ``swap_in_ema`` loads strictly.
- The recipe step against the JAX ``make_recipe_train_step`` (f32,
  ``parity_mode()``, three AdamW steps with warmup and an EMA, the JAX
  draws injected, a one-device JAX mesh): a small Mixer, RaftMLP (drop-path
  under ``torch_parity.fixed_drop_path_masks``) and ConvMixer (BatchNorm,
  ``bn_momentum=None``): parameters, EMA, loss, accuracy and ``grad_norm``
  within 1e-4. With the default ``bn_momentum`` the running statistics
  move as ``make_train_step`` moves them on the same mixed images. A bf16
  run of 20 steps keeps the masters, the EMA and the optimizer state in
  f32, and the loss falls.
- ``nnf.dropout``, ``utils.trunc_normal_`` (bit-equal to JAX's).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu import train_recipes as jr
from jittor_mlp_tpu import utils as jutils
from jittor_mlp_tpu.parallel import make_mesh
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch import train_recipes as tr
from jittor_mlp_tpu_torch import utils as tutils
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.parallel import make_train_step
from jittor_mlp_tpu_torch.utils.serialization import restore_train_state, save_train_state

CPU = dict(device="cpu")
MIXER = dict(d_model=32, depth=2, patch_size=8, image_size=16, token_dim=24, num_classes=10,
             seed=11)
TINY = dict(d_model=8, depth=1, patch_size=4, image_size=8, num_classes=4)


def test_smoothing_and_soft_cross_entropy_match_jax_and_torch():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16)
    soft = tr.smooth_labels(torch.from_numpy(labels), 10, 0.1)
    jsoft = jr.smooth_labels(jnp.asarray(labels), 10, 0.1)
    assert soft.dtype == torch.float32
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), rtol=0, atol=1e-6)
    got = tr.soft_cross_entropy(torch.from_numpy(logits), soft).item()
    want = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           label_smoothing=0.1).item()
    assert abs(got - want) < 1e-6
    assert abs(got - float(jr.soft_cross_entropy(jnp.asarray(logits), jsoft))) < 1e-6
    # bf16 logits: the loss is taken in f32
    bf = tr.soft_cross_entropy(torch.from_numpy(logits).bfloat16(), soft)
    assert bf.dtype == torch.float32


def jax_scalars(k_mix, height, width, mixup_alpha, cutmix_alpha, switch_prob):
    """The coin, mixup λ, cutmix λ and box centre that the JAX
    ``mixup_cutmix(k_mix, ...)`` draws (train_recipes.py:98-120, 68-70)."""
    k_mode, k_beta1, k_beta2, k_box = jax.random.split(k_mix, 4)
    coin = bool(jax.random.bernoulli(k_mode, switch_prob))
    lam_mix = (np.float32(jax.random.beta(k_beta1, mixup_alpha, mixup_alpha))
               if mixup_alpha > 0 else np.float32(1.0))
    lam_cut = (np.float32(jax.random.beta(k_beta2, cutmix_alpha, cutmix_alpha))
               if cutmix_alpha > 0 else np.float32(1.0))
    kc, kr = jax.random.split(k_box)
    return (coin, lam_mix, lam_cut, int(jax.random.randint(kc, (), 0, height)),
            int(jax.random.randint(kr, (), 0, width)))


def jax_step_draws(rng, step, shape, recipe):
    """The port's ``MixDraws`` for the JAX recipe step's step ``step``
    (its mix key: split(fold_in(rng, step))[0], train_recipes.py:234)."""
    k_mix, _ = jax.random.split(jax.random.fold_in(rng, step))
    return tr.draws_from(*jax_scalars(k_mix, shape[1], shape[2], recipe.mixup_alpha,
                                      recipe.cutmix_alpha, recipe.switch_prob),
                         shape, recipe.mixup_alpha, recipe.cutmix_alpha)


@pytest.mark.parametrize("alphas", [(0.8, 1.0), (0.8, 0.0), (0.0, 1.0)],
                         ids=["both", "mixup", "cutmix"])
def test_mix_with_jax_draws_equals_jax(alphas):
    ma, ca = alphas
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((6, 3, 20, 24)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    jsoft = jr.smooth_labels(jnp.asarray(labels), 5, 0.1)
    soft = tr.smooth_labels(torch.from_numpy(labels), 5, 0.1)
    modes = set()
    for seed in range(10):
        key = jax.random.PRNGKey(seed)
        want_img, want_lab = jr.mixup_cutmix(key, jnp.asarray(imgs), jsoft, ma, ca, 0.5)
        draws = tr.draws_from(*jax_scalars(key, 20, 24, ma, ca, 0.5), (6, 20, 24), ma, ca)
        got_img, got_lab = tr.mix(torch.from_numpy(imgs), soft, draws)
        modes.add(draws.cutmix)
        assert got_img.dtype == torch.float32
        np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
        np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), rtol=0, atol=1e-7)
    assert modes == {(0.8, 1.0): {True, False}, (0.8, 0.0): {False}, (0.0, 1.0): {True}}[alphas]


def test_no_mix_is_the_identity_and_bf16_mixup_keeps_its_dtype():
    imgs = torch.ones(2, 3, 8, 8)
    soft = tr.smooth_labels(torch.tensor([0, 1]), 2, 0.0)
    mi, ml = tr.mixup_cutmix(torch.Generator().manual_seed(0), imgs, soft, 0.0, 0.0)
    assert mi is imgs and ml is soft
    assert tr.mix_draws(torch.Generator(), 2, 8, 8, 0.0, 0.0) is None
    x = torch.randn(4, 3, 8, 8).bfloat16()
    draws = tr.draws_from(False, np.float32(0.3), np.float32(1.0), 0, 0, (4, 8, 8), 0.8, 0.0)
    mixed, _ = tr.mix(x, tr.smooth_labels(torch.arange(4), 4), draws)
    want = (0.3 * x.float() + float(np.float32(1) - np.float32(0.3)) * x.flip(0).float())
    assert mixed.dtype == torch.bfloat16 and torch.equal(mixed, want.bfloat16())
    with pytest.raises(ValueError, match="draws made for"):
        tr.mix(x[:2], tr.smooth_labels(torch.arange(2), 4), draws)


def test_port_draws_are_reproducible_and_distributed():
    def draw_all(seed, n, **kw):
        g = torch.Generator().manual_seed(seed)
        return [tr.mix_draws(g, 4, 32, 40, **kw) for _ in range(n)]

    assert draw_all(3, 20) == draw_all(3, 20)
    assert draw_all(3, 20) != draw_all(4, 20)
    mixup = draw_all(5, 2000, mixup_alpha=0.8, cutmix_alpha=0.0)
    assert not any(d.cutmix for d in mixup)
    assert abs(np.mean([d.lam for d in mixup]) - 0.5) < 0.02
    both = draw_all(6, 2000, switch_prob=0.3)
    assert abs(np.mean([d.cutmix for d in both]) - 0.3) < 0.04
    imgs = torch.randn(4, 3, 32, 40)
    soft = tr.smooth_labels(torch.arange(4), 4, 0.1)
    for d in [d for d in both if d.cutmix][:50]:
        y0, y1, x0, x1 = d.box
        assert d.lam == np.float32(1) - np.float32((y1 - y0) * (x1 - x0)) / np.float32(32 * 40)
        mixed, lab = tr.mix(imgs, soft, d)
        moved = (mixed != imgs).float().mean().item()  # partner pixels (all differ here)
        assert abs(moved - (1 - float(d.lam))) < 1e-6
        assert abs(lab[0, 0].item() - (float(d.lam) * 0.925 + (1 - float(d.lam)) * 0.025)) < 1e-6


def test_cutmix_box_is_jax_float32_arithmetic():
    """The box and corrected λ of the JAX ``_cutmix_mask`` at its own
    centre draws, for λ where a float32 side rounds."""
    for lam in (0.0, 0.36, 0.5, 0.75, 0.9999, 1.0, 0.1234567):
        for seed in range(4):
            key = jax.random.PRNGKey(seed)
            inside, want = jr._cutmix_mask(key, 16, 20, jnp.float32(lam))
            kc, kr = jax.random.split(key)
            cy, cx = (int(jax.random.randint(k, (), 0, n)) for k, n in ((kc, 16), (kr, 20)))
            (y0, y1, x0, x1), got = tr.cutmix_box(16, 20, np.float32(lam), cy, cx)
            assert got == np.float32(want)
            mask = np.zeros((16, 20), bool)
            mask[y0:y1, x0:x1] = True
            np.testing.assert_array_equal(mask, np.asarray(inside))


def test_ema_update_matches_jax_and_swap_in_ema_loads_strictly():
    rng = np.random.default_rng(2)
    ema = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("a", (3, 5)), ("b", (7,)))}
    new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    want = jr.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                         {k: jnp.asarray(v) for k, v in new.items()}, 0.999)
    tema = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    out = tr.ema_update(tema, {k: torch.from_numpy(v) for k, v in new.items()}, 0.999)
    assert out is tema
    for k in ema:
        np.testing.assert_allclose(tema[k].numpy(), np.asarray(want[k]), rtol=1e-7, atol=1e-7)
    model = jt.MLPMixerForImageClassification(**TINY, **CPU)
    state = tr.init_recipe_state(model, torch.optim.AdamW(model.parameters()),
                                 recipe=tr.Recipe(ema_decay=0.5))
    for v in state.ema.values():
        v.add_(1.0)
    sd = tr.swap_in_ema(model, state.ema)
    other = jt.MLPMixerForImageClassification(**TINY, seed=5, **CPU).to_bf16()
    jt.Predictor(other, batch_size=2, image_size=8).model.load_state_dict(sd, strict=True)
    for k, p in model.named_parameters():
        assert torch.equal(sd[k], p.detach() + 1.0)
        assert torch.equal(other.state_dict()[k], (p.detach() + 1.0).bfloat16())


def _batches(n, size, classes, seed=0, batch=8):
    protos = np.random.default_rng(seed).standard_normal((classes, 3, size, size))
    out = []
    for i in range(n):
        rs = np.random.default_rng(100 + i)
        lab = rs.integers(0, classes, batch)
        img = protos[lab] + 0.3 * rs.standard_normal((batch, 3, size, size))
        out.append({"image": torch.from_numpy(img.astype(np.float32)),
                    "label": torch.from_numpy(lab)})
    return out


def _recipe_run(model, schedule, batches, recipe, start=None, step0=0):
    opt = torch.optim.AdamW(model.parameters(), lr=1.0, weight_decay=1e-4)
    state = tr.init_recipe_state(model, opt, recipe=recipe)
    if start is not None:
        step0 = restore_train_state(start, model, opt)
        state = state._replace(step=step0)
    step = tr.make_recipe_train_step(model, opt, 4, recipe, lr_schedule=schedule)
    gen = torch.Generator().manual_seed(0)
    lrs = []
    for b in batches[step0:]:
        state, _ = step(state, b, gen)
        lrs.append(opt.param_groups[0]["lr"])
    return lrs, opt, state


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedules_drive_adamw_as_optax(kind, warmup, tmp_path):
    total = 20
    want_fn = jr.make_lr_schedule(2e-3, total, warmup, kind, min_lr=1e-4)
    schedule = tr.make_lr_schedule(2e-3, total, warmup, kind, min_lr=1e-4)
    recipe = tr.Recipe(mixup_alpha=0.2, cutmix_alpha=0.2)
    batches = _batches(total + 6, 8, 4)
    torch.manual_seed(0)
    lrs, _, _ = _recipe_run(jt.MLPMixerForImageClassification(**TINY, **CPU), schedule,
                            batches, recipe)
    want = [float(want_fn(k)) for k in range(total + 6)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-12)
    assert lrs == [schedule(k) for k in range(total + 6)]
    # stopped after update 9, saved, restored into fresh objects: the same lrs and weights
    model = jt.MLPMixerForImageClassification(**TINY, **CPU)
    _, opt, state = _recipe_run(model, schedule, batches[:10], recipe)
    path = save_train_state(str(tmp_path / "state.pt"), model, opt, state.step)
    resumed = jt.MLPMixerForImageClassification(**TINY, seed=3, **CPU)
    rest, _, _ = _recipe_run(resumed, schedule, batches, recipe, start=path)
    assert rest == lrs[10:]
    whole = jt.MLPMixerForImageClassification(**TINY, **CPU)
    _recipe_run(whole, schedule, batches, recipe)
    for (k, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), k


def test_unknown_schedule_mesh_and_int8_raise():
    with pytest.raises(ValueError, match="unknown schedule kind"):
        tr.make_lr_schedule(1e-3, 10, kind="step")
    model = jt.MLPMixerForImageClassification(**TINY, **CPU)
    opt = torch.optim.AdamW(model.parameters())
    with pytest.raises(NotImplementedError, match="mesh"):
        tr.init_recipe_state(model, opt, mesh=object())
    step = tr.make_recipe_train_step(model, opt, 4)
    with config.int8_mode(), pytest.raises(RuntimeError, match="inference-only"):
        step(tr.init_recipe_state(model, opt), _batches(1, 8, 4)[0], torch.Generator())
    assert tr.Recipe() == tr.Recipe(0.8, 1.0, 0.5, 0.1, 0.0)
    assert tr.RecipeState._fields == jr.RecipeState._fields


RECIPE = tr.Recipe(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, label_smoothing=0.1,
                   ema_decay=0.9)
PARITY = {  # name: (JAX factory, port factory, kwargs, image side, bn_momentum)
    "mlp_mixer": (jm.MLPMixerForImageClassification, jt.MLPMixerForImageClassification,
                  MIXER, 16, 0.1),
    "raft_mlp": (jm.RaftMLP, jt.RaftMLP, {**tp.RAFT, "drop_path_rate": 0.3}, 16, 0.1),
    "conv_mixer": (jm.ConvMixer, jt.ConvMixer, tp.CONV_MIXER, 32, None),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_recipe_steps_match_jax(name, monkeypatch):
    """Three f32 AdamW steps (lr 1e-2, warmup 1 of 6 cosine, Adam eps 1e-4
    as ``torch_parity.check_train_steps``, EMA 0.9) of both recipe steps on
    the same weights, batches and mix draws."""
    jax_factory, port_factory, kwargs, side, bn_momentum = PARITY[name]
    tp.fixed_drop_path_masks(monkeypatch)
    batches = [tp.train_batch((4, 3, side, side), seed=s) for s in range(3)]
    rng = jax.random.PRNGKey(7)
    jmodel = jax_factory(**kwargs)
    model = port_factory(**kwargs, **CPU)
    model.load_torch_state_dict(jmodel.export_torch_state_dict(tensors=False))
    init_sd = copy.deepcopy(model.state_dict())

    jopt = optax.adamw(jr.make_lr_schedule(1e-2, 6, 1), eps=1e-4)
    mesh = make_mesh(1)
    jstate = jr.init_recipe_state(jax.tree.map(jnp.array, jmodel.params), jopt, mesh, RECIPE)
    jstep = jr.make_recipe_train_step(jmodel.apply, jopt, 10, RECIPE)
    want = []
    with jconfig.parity_mode(), mesh:
        for b in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in b.items()}, rng)
            want.append({k: float(v) for k, v in m.items()})

    draws = iter([jax_step_draws(rng, s, (4, side, side), RECIPE) for s in range(3)])
    monkeypatch.setattr(tr, "mix_draws", lambda *args: next(draws))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4, eps=1e-4)
    state = tr.init_recipe_state(model, opt, recipe=RECIPE)
    step = tr.make_recipe_train_step(model, opt, 10, RECIPE, bn_momentum=bn_momentum,
                                     lr_schedule=tr.make_lr_schedule(1e-2, 6, 1))
    got = []
    with config.parity_mode():
        for b in batches:
            state, m = step(state, b, torch.Generator().manual_seed(0))
            got.append({k: v.item() for k, v in m.items()})
    assert state.step == 3 and int(jstate.step) == 3
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) < 1e-4, (k, got, want)
    jmodel.params = jstate.params
    jsd = jmodel.export_torch_state_dict(tensors=False)
    tsd = model.export_torch_state_dict(tensors=False)
    jmodel.params = jr.swap_in_ema(jstate.params, jstate.ema)
    jema = jmodel.export_torch_state_dict(tensors=False)
    tema = {k: v.float().numpy() for k, v in tr.swap_in_ema(model, state.ema).items()}
    assert sorted(tsd) == sorted(jsd) == sorted(tema)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(tema[k], jema[k], rtol=0, atol=1e-4, err_msg=k)
        if "running_" in k:  # bn_momentum=None: untouched, as in the JAX recipe step
            assert torch.equal(model.state_dict()[k], init_sd[k]), k
    assert any(np.abs(tsd[k] - tema[k]).max() > 1e-4 for k in tsd)  # the EMA lags


def test_bn_statistics_move_as_make_train_step_moves_them():
    """ConvMixer under the recipe with the default bn_momentum: the running
    statistics after one step are those ``make_train_step`` leaves on the
    step's mixed images, bit for bit; with None they stay."""
    batch = tp.train_batch((4, 3, 32, 32))
    model = jt.ConvMixer(**tp.CONV_MIXER, **CPU)
    twin = copy.deepcopy(model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    state, _ = tr.make_recipe_train_step(model, opt, 10, RECIPE)(
        tr.init_recipe_state(model, opt, recipe=RECIPE), batch, torch.Generator().manual_seed(0))
    soft = tr.smooth_labels(batch["label"], 10, RECIPE.label_smoothing)
    mixed, _ = tr.mixup_cutmix(tr.mix_generator(torch.Generator().manual_seed(0), 0),
                               batch["image"], soft, RECIPE.mixup_alpha, RECIPE.cutmix_alpha,
                               RECIPE.switch_prob)
    make_train_step(twin, torch.optim.AdamW(twin.parameters(), lr=1e-2))(
        {"image": mixed, "label": batch["label"]})
    stats = [k for k in init if "running_" in k]
    assert stats
    for k in stats:
        assert torch.equal(model.state_dict()[k], twin.state_dict()[k]), k
        assert not torch.equal(model.state_dict()[k], init[k]), k
    model.load_state_dict(init)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    tr.make_recipe_train_step(model, opt, 10, RECIPE, bn_momentum=None)(
        tr.init_recipe_state(model, opt, recipe=RECIPE), batch, torch.Generator().manual_seed(0))
    for k in stats:
        assert torch.equal(model.state_dict()[k], init[k]), k


def test_bf16_recipe_keeps_f32_state_and_descends():
    model = jt.MLPMixerForImageClassification(image_size=16, patch_size=4, d_model=32, depth=2,
                                              num_classes=4, **CPU)
    recipe = tr.Recipe(mixup_alpha=0.2, cutmix_alpha=0.2, label_smoothing=0.1, ema_decay=0.9)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3)
    state = tr.init_recipe_state(model, opt, recipe=recipe)
    step = tr.make_recipe_train_step(model, opt, 4, recipe, compute_dtype=torch.bfloat16,
                                     lr_schedule=tr.make_lr_schedule(3e-3, 20, 2))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for b in _batches(20, 16, 4, batch=16):
        state, m = step(state, b, gen)
        losses.append(m["loss"].item())
        assert all(v.dtype == torch.float32 and v.dim() == 0 for v in m.values())
        assert 0.0 <= m["accuracy"].item() <= 1.0
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    for group in (state.params.values(), state.ema.values(),
                  [t for s in opt.state.values() for t in s.values() if t.is_floating_point()]):
        assert all(t.dtype == torch.float32 for t in group)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_dropout_identity_rate_scaling_and_reproducibility():
    x = torch.randn(64, 128)
    g = torch.Generator().manual_seed(0)
    assert nnf.dropout(x, 0.3, False, g) is x
    assert nnf.dropout(x, 0.0, True, g) is x
    assert nnf.dropout(x, 0.3, True, None) is x
    y = nnf.dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    keep = float(np.float32(0.7))
    assert torch.equal(y[kept], x[kept] / keep)
    assert torch.equal(y, nnf.dropout(x, 0.3, True, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, nnf.dropout(x, 0.3, True, torch.Generator().manual_seed(2)))
    yb = nnf.dropout(x.bfloat16(), 0.3, True, torch.Generator().manual_seed(1))
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)


def test_trunc_normal_equals_jax():
    for shape, kw in (((5, 7), {}), ((1000,), dict(mean=0.5, std=0.02, a=-0.1, b=1.1, seed=3))):
        got = tutils.trunc_normal_(shape, **kw)
        want = jutils.trunc_normal_(shape, **kw)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    assert tutils.trunc_normal is not None and "trunc_normal_" in tutils.__all__
