"""Training of the drop-path families and the plain ones: the port's
``make_train_step`` against jittor_mlp_tpu's, on the CPU.

- Two float32 AdamW(1e-2) steps against the JAX ``make_train_step`` on the
  same seeded weights and batch (``torch_parity.check_train_steps``):
  losses and the whole exported state dict within 1e-4. The ten drop-path
  models run at a nonzero rate with one mask pattern on both sides
  (``torch_parity.fixed_drop_path_masks``: the even samples kept), which
  holds each drop-path's place, per-block rate, scaling and CycleMLP's
  ``/ skip_lam`` against JAX (MorphMLP's and ConvMLP's steps, with their
  BatchNorm, are in test_torch_train_bn.py); ViP and S2-MLP v1 and v2,
  which have neither, at their small configurations.
- The port's own contract, per drop-path model: its per-block rates equal
  the JAX model's ``_dpr`` leaves, linspace or settings; the same
  generator seed gives the same loss and gradients with and without
  ``config.remat_mode()`` (and ``use_checkpoint`` where the factory takes
  it); another seed, or none, another loss; eval ignores the generator.
- Every one of the 22 families: a factory given a nonzero drop-path rate
  (argument or setting) is ``stochastic`` and its train forward with a
  generator differs from the one without; a family without drop-path in
  the JAX package has no drop-path site.
"""

import contextlib

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.models import active_mlp as jactive
from jittor_mlp_tpu.models import conv_mlp as jconv_mlp
from jittor_mlp_tpu.models import cycle_mlp as jcycle
from jittor_mlp_tpu.models import dyna_mlp as jdyna
from jittor_mlp_tpu.models import morph_mlp as jmorph
from jittor_mlp_tpu.models.s2_mlp_v1 import S2MLPv1 as JS2MLPv1
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.models import conv_mlp as tconv_mlp
from jittor_mlp_tpu_torch.models import cycle_mlp as tcycle
from jittor_mlp_tpu_torch.models.s2_mlp_v1 import S2MLPv1
from jittor_mlp_tpu_torch.parallel import loss_fn

GF = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32, depth=3)
PYR = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=[16, 32, 48, 64],
           depth=[1, 1, 2, 1])
NULL = contextlib.nullcontext

# name: (JAX factory, port factory, kwargs with a nonzero drop-path rate,
# image side, settings context)
DROP_PATH = {
    "swin_mlp": (jm.SwinMLP, jt.SwinMLP, {**tp.SWIN, "drop_path_rate": 0.5}, 32, NULL),
    "ms_mlp": (jm.MS_MLP, jt.MS_MLP, {**tp.MS, "drop_path_rate": 0.5}, 32, NULL),
    "dyna_mlp": (jm.DynaMixer, jt.DynaMixer, tp.DYNA, 32, lambda: tp.dyna_xs(0.3)),
    "raft_mlp": (jm.RaftMLP, jt.RaftMLP, {**tp.RAFT, "drop_path_rate": 0.3}, 16, NULL),
    "cycle_mlp": (jcycle.CycleNet, tcycle.CycleNet, {**tp.CYCLE, "drop_path_rate": 0.5,
                                                     "skip_lam": 2.0}, 32, NULL),
    "active_mlp": (jactive.ActiveMLP, jt.models.active_mlp.ActiveMLP,
                   {**tp.ACTIVE, "drop_path_rate": 0.5}, 32, NULL),
    "gfnet": (jm.GFNet, jt.GFNet, {**GF, "drop_path_rate": 0.5}, 32, NULL),
    "gfnet_pyramid": (jm.GFNetPyramid, jt.GFNetPyramid, {**PYR, "drop_path_rate": 0.5}, 32,
                      NULL),
    "morph_mlp": (jm.MorphMLP, jt.MorphMLP, tp.MORPH, 32, lambda: tp.morph_xs(0.3)),
    "conv_mlp": (jconv_mlp.ConvMLP, tconv_mlp.ConvMLP, tp.CONV_MLP, 64, NULL),
}
BATCHNORM = ("morph_mlp", "conv_mlp")  # their steps: test_torch_train_bn.py
PLAIN = {
    "vip": (jm.ViP, jt.ViP, tp.VIP, 32, NULL),
    "s2_mlp_v1": (JS2MLPv1, S2MLPv1, tp.S2, 32, NULL),
    "s2_mlp_v2": (jm.S2MLPv2, jt.S2MLPv2, tp.S2, 32, NULL),
}


@pytest.mark.parametrize("name", [k for k in DROP_PATH if k not in BATCHNORM] + list(PLAIN))
def test_f32_adamw_steps_match_jax(name, monkeypatch):
    """DynaMixer's rate is its XS setting's 0.3."""
    jf, tf, kw, hw, settings = {**DROP_PATH, **PLAIN}[name]
    tp.fixed_drop_path_masks(monkeypatch)
    with settings():
        model, losses = tp.check_train_steps(jf, tf, kw, (4, 3, hw, hw))
    assert model.stochastic == (name in DROP_PATH)
    assert np.isfinite(losses).all()


def _jax_rates(name, jmodel):
    """The JAX model's per-block drop-path rates, in block order: its
    ``_dpr`` leaves, or the value its ``apply`` reads."""
    p = jmodel.params
    if name in ("ms_mlp", "conv_mlp"):
        return np.concatenate([np.asarray(st["blocks"]["_dpr"])
                               for st in p["layers" if name == "ms_mlp" else "stages"]])
    if name in ("cycle_mlp", "gfnet_pyramid"):
        return np.concatenate([np.asarray(st["_dpr"] if name == "gfnet_pyramid" else
                                          st["blocks"]["_dpr"])
                               for st in p["stages" if name == "cycle_mlp" else "blocks"]])
    if name == "gfnet":
        return np.asarray(p["blocks"]["_dpr"])
    raise KeyError(name)


def _port_rates(model):
    return np.array([m.drop_path_rate for m in model.modules() if hasattr(m, "drop_path_rate")],
                    np.float32)


@pytest.mark.parametrize("name", list(DROP_PATH))
def test_per_block_rates_equal_jax(name):
    """The rates each drop-path site of the port applies, against JAX's:
    the ``_dpr`` leaves where the JAX params hold them, else the source
    its forward reads (SwinMLP's and ActiveMLP's ``dpr_all``, the
    settings' rate of DynaMixer and MorphMLP,
    RaftMLP's constant ``drop_path_rate`` for each mixer)."""
    jf, tf, kw, hw, settings = DROP_PATH[name]
    with settings():
        model = tf(**kw, **tp.CPU)
        got = _port_rates(model)
        if name in ("swin_mlp", "active_mlp"):  # read by the apply from its closure
            apply = jf(**kw).apply
            cells = dict(zip(apply.__code__.co_freevars, apply.__closure__))
            want = cells["dpr_all"].cell_contents
        elif name == "dyna_mlp":
            want = np.full(sum(jdyna.dynamlp_settings["XS"][2]), 0.3, np.float32)
        elif name == "morph_mlp":
            layers, *_, stoch = jmorph.morphmlp_settings["XS"]
            want = np.concatenate([np.full(n, s, np.float32) for n, s in zip(layers, stoch)])
        elif name == "raft_mlp":
            mixers = sum(3 * layer["depth"] for layer in kw["layers"])  # ser_pm: 3 a block
            want = np.full(mixers, 0.3, np.float32)
        else:
            want = _jax_rates(name, jf(**kw))
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0


def _grads(model, batch, generator, dtype=None):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, dtype, generator)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                           if p.grad is not None}


CHECKPOINTED = ("swin_mlp", "ms_mlp")  # factories with use_checkpoint


@pytest.mark.parametrize("name", list(DROP_PATH))
def test_drop_path_follows_the_generator_and_survives_remat(name):
    """The same generator seed gives the same loss and gradients with and
    without checkpointing (the masks are drawn before the blocks run) and
    with ``use_checkpoint``; another seed, or none, gives other gradients
    (MS-MLP's 1e-6 layer scale hides them in its loss); eval ignores the
    generator. Eight images: ConvMLP's one block at rate 0.1 keeps all
    four of a smaller batch for both seeds."""
    jf, tf, kw, hw, settings = DROP_PATH[name]
    batch = tp.train_batch((8, 3, hw, hw))
    with settings():
        model = tf(**kw, **tp.CPU)
        ckpt = tf(**kw, use_checkpoint=True, **tp.CPU) if name in CHECKPOINTED else None
    l0, g0 = _grads(model, batch, torch.Generator().manual_seed(1))
    with config.remat_mode():
        runs = [_grads(model, batch, torch.Generator().manual_seed(1))]
    if ckpt is not None:
        runs.append(_grads(ckpt, batch, torch.Generator().manual_seed(1)))
    for loss, grads in runs:
        assert torch.equal(loss, l0) and grads.keys() == g0.keys()
        for k in g0:
            assert torch.equal(grads[k], g0[k]), k
    for generator in (torch.Generator().manual_seed(2), None):
        _, g = _grads(model, batch, generator)
        assert any(not torch.equal(g[k], g0[k]) for k in g0)
    model.eval()
    with torch.no_grad():
        x = batch["image"]
        assert torch.equal(model.forward(x, torch.Generator().manual_seed(1)), model.forward(x))


# every family of the port: (factory, small kwargs, the kwargs or settings
# context that give it a nonzero drop-path rate, or None: no drop-path in
# the JAX package), image side
MIXER = dict(image_size=32, patch_size=8, d_model=32, depth=2, num_classes=10)
ALL = {
    "mlp_mixer": (jt.MLPMixerForImageClassification, MIXER, None, 32),
    "res_mlp": (jt.ResMLPForImageClassification, MIXER, None, 32),
    "g_mlp": (jt.gMLPForImageClassification,
              dict(image_size=32, patch_size=8, d_model=32, d_ffn=64, depth=2, num_classes=10),
              None, 32),
    "as_mlp": (jt.AS_MLP, dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                               depths=[2, 2], shift_size=3), {"drop_path_rate": 0.5}, 32),
    "vip": (jt.ViP, tp.VIP, None, 32),
    "s2_mlp_v1": (S2MLPv1, tp.S2, None, 32),
    "s2_mlp_v2": (jt.S2MLPv2, tp.S2, None, 32),
    "hire_mlp": (jt.HireMLP, tp.HIRE, None, 32),
    "sequencer": (jt.Sequencer2D, tp.SEQ, None, 28),
    "conv_mixer": (jt.ConvMixer, tp.CONV_MIXER, None, 32),
    "sparse_mlp": (jt.SparseMLP, tp.SPARSE, None, 32),
    "wave_mlp": (jt.WaveMLP, tp.WAVE, None, 64),
    "repmlpnet": (jt.models.repmlpnet.RepMLPNet, tp.REPMLP, None, 16),
    **{k: (tf, kw, {}, hw) for k, (_jf, tf, kw, hw, _s) in DROP_PATH.items()},
}
SETTINGS = {"sequencer": tp.sequencer_xs, "wave_mlp": tp.wave_xs}


@pytest.mark.parametrize("name", list(ALL))
def test_no_family_ignores_its_drop_path_rate(name):
    factory, kw, dp, hw = ALL[name]
    settings = DROP_PATH[name][4] if name in DROP_PATH else SETTINGS.get(name, NULL)
    with settings():
        model = factory(**kw, **(dp or {}), **tp.CPU)
    sites = [m for m in model.modules() if hasattr(m, "drop_path_rate")]
    if dp is None:
        assert not model.stochastic and not sites
        return
    assert model.stochastic and max(m.drop_path_rate for m in sites) > 0
    x = tp.train_batch((4, 3, hw, hw))["image"]
    with torch.no_grad():
        plain = model.train().forward(x)
        dropped = model.forward(x, torch.Generator().manual_seed(0))
        model.eval()
        if name not in ("morph_mlp", "conv_mlp"):  # BatchNorm: eval reads the running stats
            assert torch.equal(model.forward(x), plain)
    assert not torch.equal(dropped, plain)

