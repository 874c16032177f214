"""Training of the six BatchNorm families, and of Hire-MLP and Sequencer2D:
the port's ``make_train_step`` against jittor_mlp_tpu's, on the CPU.

- Two float32 AdamW(1e-2) steps against the JAX ``make_train_step``
  (``torch_parity.check_train_steps``): losses and the whole exported
  state dict, running statistics included, within 1e-4. MorphMLP and
  ConvMLP also drop paths, at their XS setting's 0.3 and at the code's 0
  to 0.1 a stage, with one mask pattern on both sides.
- The running-statistic EMA: ``bn_momentum=None`` leaves every buffer as
  it was; a bf16 step moves the float32 running statistics by exactly the
  EMA of the batch statistics of the bf16 forward (the sink sees the cast
  copies and the step writes the model's own buffers); a checkpointed
  forward's recompute adds nothing (remat gives the same buffers).
- RepMLPNet trains with ``deploy=False`` and folds after a step.
"""

import contextlib

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.models import conv_mlp as jconv_mlp
from jittor_mlp_tpu.models import repmlpnet as jrep
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.models import conv_mlp as tconv_mlp
from jittor_mlp_tpu_torch.models import repmlpnet as trep
from jittor_mlp_tpu_torch.parallel import make_train_step
from jittor_mlp_tpu_torch.parallel.train import _Forward, cast_floating

NULL = contextlib.nullcontext
# name: (JAX factory, port factory, kwargs, image side, settings context)
BN = {
    "conv_mixer": (jm.ConvMixer, jt.ConvMixer, tp.CONV_MIXER, 32, NULL),
    "sparse_mlp": (jm.SparseMLP, jt.SparseMLP, tp.SPARSE, 32, NULL),
    "wave_mlp": (jm.WaveMLP, jt.WaveMLP, tp.WAVE, 32, tp.wave_xs),
    "repmlpnet": (jrep.RepMLPNet, trep.RepMLPNet, tp.REPMLP, 16, NULL),
    "morph_mlp": (jm.MorphMLP, jt.MorphMLP, tp.MORPH, 32, lambda: tp.morph_xs(0.3)),
    "conv_mlp": (jconv_mlp.ConvMLP, tconv_mlp.ConvMLP, tp.CONV_MLP, 64, NULL),
}
PLAIN = {
    "hire_mlp": (jm.HireMLP, jt.HireMLP, tp.HIRE, 32, NULL),
    "sequencer": (jm.Sequencer2D, jt.Sequencer2D, tp.SEQ, 28, tp.sequencer_xs),
}


@pytest.mark.parametrize("name", list(BN) + list(PLAIN))
def test_f32_adamw_steps_match_jax(name, monkeypatch):
    """WaveMLP at 32 px: at 64 px its loss falls from 2.58 to 0.064 in the
    first step (the state dicts then agree within 1.2e-5), and the second
    step's update of its theta convs, behind a ReLU, spreads to 6.4e-4."""
    jf, tf, kw, hw, settings = {**BN, **PLAIN}[name]
    tp.fixed_drop_path_masks(monkeypatch)
    with settings():
        model, losses = tp.check_train_steps(jf, tf, kw, (4, 3, hw, hw))
    assert np.isfinite(losses).all()
    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean",
                                                                        "running_var"))}
    assert bool(stats) == (name in BN)
    for k, v in stats.items():  # the EMA moved every one of them
        assert not torch.equal(v, torch.zeros_like(v) if k.endswith("mean")
                               else torch.ones_like(v)), k


def _model(name, **extra):
    _jf, tf, kw, hw, settings = BN[name]
    with settings():
        return tf(**kw, **extra, **tp.CPU), tp.train_batch((4, 3, hw, hw))


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


@pytest.mark.parametrize("name", list(BN))
def test_bn_momentum_none_leaves_the_buffers(name):
    model, batch = _model(name)
    before = _buffers(model)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), bn_momentum=None)
    assert np.isfinite(float(step(batch)))
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("name", ["conv_mixer", "sparse_mlp", "wave_mlp", "repmlpnet"])
def test_bf16_step_updates_the_f32_statistics_by_the_ema(name):
    """One bf16 step (lr 0, so the weights stay): every running statistic
    moves, stays float32, and equals (1 - m)·old + m·new of the batch
    statistics that the same bf16 forward reports (variance unbiased by
    n/(n - 1), n the elements per channel); num_batches_tracked stays."""
    model, batch = _model(name)
    before = _buffers(model)
    fwd = _Forward(model.train())
    cast = cast_floating({**dict(fwd.named_parameters()), **dict(fwd.named_buffers())},
                         torch.bfloat16)
    names = {id(v): k for k, v in cast.items()}
    with nnf.bn_stats() as stats, torch.no_grad():
        torch.func.functional_call(fwd, cast, (batch["image"].bfloat16(),))
    assert stats and all(names[id(rm)].endswith("running_mean") for rm, *_ in stats)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                           compute_dtype=torch.bfloat16, bn_momentum=0.25)
    step(batch)
    after = dict(model.named_buffers())
    for rm, mean, var, n in stats:
        key = names[id(rm)][len("model."):-len("running_mean")]
        want_m = 0.75 * before[key + "running_mean"] + 0.25 * mean
        want_v = 0.75 * before[key + "running_var"] + 0.25 * var * (n / (n - 1))
        assert after[key + "running_mean"].dtype == torch.float32
        torch.testing.assert_close(after[key + "running_mean"], want_m, rtol=0, atol=1e-6)
        torch.testing.assert_close(after[key + "running_var"], want_v, rtol=0, atol=1e-6)
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0, k
        elif k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("name", ["wave_mlp", "morph_mlp"])
def test_remat_recompute_adds_no_statistics(name):
    """The backward's recompute of a checkpointed block runs its
    BatchNorms again outside the step's sink: the buffers after a step
    under ``remat_mode()`` equal those without."""
    runs = []
    for remat in (False, True):
        model, batch = _model(name)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))
        with config.remat_mode() if remat else NULL():
            step(batch)
        runs.append(_buffers(model))
    for k in runs[0]:
        torch.testing.assert_close(runs[1][k], runs[0][k], rtol=0, atol=1e-6, msg=k)


def test_repmlpnet_folds_after_training():
    model, batch = _model("repmlpnet")
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-2))
    for s in range(2):
        step(tp.train_batch((4, 3, 16, 16), seed=s))
    x = batch["image"]
    with torch.no_grad(), config.parity_mode():
        want = model.eval()(x)
        model.locality_injection()
        got = model(x)
    assert model.deploy
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
