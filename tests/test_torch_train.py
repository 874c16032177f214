"""The port's train step against the JAX one, and the trainable blocks of
ResMLP and gMLP against their JAX custom VJPs, on the CPU.

- float32: three AdamW steps of a tiny Mixer (d_model 32, depth 2, patch 8,
  image 16, token_dim 24, 10 classes, batch 4, weights from the same seed)
  through ``make_train_step`` in both packages (optax ``adamw(1e-2)``,
  torch ``AdamW(1e-2, weight_decay=1e-4, eps=1e-8)``, the same update):
  losses and parameters within 1e-4.
- bf16 mixed precision: one SGD step on each Mixer route against the JAX
  bf16 step (its plain bf16 blocks on the CPU): loss and gradients within
  a bf16 band. AdamW's first step is about lr·sign(g), which a tiny
  gradient difference flips, so Adam parameters are not compared in bf16.
- ResMLP and gMLP: ``fused_*_block_trainable`` against the JAX wrappers
  (Pallas forward in interpret mode, XLA backward) for every argument, in
  float32 within 1e-4.
- ``remat_mode()``, the int8 refusal, buffers and the train example (also
  a BatchNorm family and a drop-path family through ``sized_kwargs``,
  which equals the JAX ``sized_kwargs`` on every exported factory).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_gmlp_block import SHAPES as GMLP_SHAPES
from test_torch_gmlp_block import _inputs as gmlp_inputs
from test_torch_resmlp_block import SHAPES as RESMLP_SHAPES
from test_torch_resmlp_block import _inputs as resmlp_inputs

import jittor_mlp_tpu as jm
import jittor_mlp_tpu.ops.pallas.gmlp_block as jgb
import jittor_mlp_tpu.ops.pallas.resmlp_block as jrb
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.parallel.train import make_train_step as jax_train_step
from jittor_mlp_tpu.parallel.train import split_params
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.examples import train as train_example
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block as tgb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block_bwd as tbwd
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block as trb
from jittor_mlp_tpu_torch.parallel import cross_entropy_loss, loss_fn, make_train_step
from jittor_mlp_tpu_torch.utils import sized_kwargs

TINY = dict(d_model=32, depth=2, patch_size=8, image_size=16, token_dim=24, num_classes=10,
            seed=11)


def _batch(n=4, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 3, 16, 16)).astype(np.float32),
            r.integers(0, 10, n).astype(np.int32))


def _jax_steps(opt, n_steps, compute_dtype=None):
    """The JAX model after n_steps of make_train_step; returns (losses, state dict)."""
    jmodel = jm.MLPMixerForImageClassification(**TINY)
    params = jax.tree.map(jnp.array, jmodel.params)  # the step donates its params
    train, _, _, _ = split_params(params)
    opt_state = opt.init(train)
    step = jax_train_step(jmodel.apply, opt, compute_dtype=compute_dtype)
    x, y = _batch()
    losses = []
    for s in range(n_steps):
        params, opt_state, loss = step(params, opt_state,
                                       {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                       jax.random.PRNGKey(s))
        losses.append(float(loss))
    jmodel.params = params
    return losses, jmodel.export_torch_state_dict(tensors=False)


def _port_steps(opt_fn, n_steps, compute_dtype=None):
    model = jt.MLPMixerForImageClassification(**TINY, device="cpu")
    step = make_train_step(model, opt_fn(model.parameters()), compute_dtype=compute_dtype)
    x, y = _batch()
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    losses = [float(step(batch)) for _ in range(n_steps)]
    return losses, model.export_torch_state_dict(tensors=False)


def _zero_grad_params(model, batch):
    """Parameters whose f32 gradient is zero up to rounding: each token
    mix's output bias shifts all channels of a token alike, which every
    LayerNorm after it removes. Adam scales such rounding noise up to a
    full step of either sign, so the two packages cannot agree on them."""
    with config.parity_mode():
        loss_fn(model, batch).backward()
    top = max(p.grad.abs().max().item() for p in model.parameters())
    return {k for k, p in model.named_parameters() if p.grad.abs().max().item() <= 1e-6 * top}


def test_f32_adamw_steps_match_jax():
    with jconfig.parity_mode():
        jl, jsd = _jax_steps(optax.adamw(1e-2), 3)
    with config.parity_mode():
        tl, tsd = _port_steps(
            lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=1e-4, eps=1e-8), 3)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl[-1] < tl[0]
    assert list(tsd) == list(jsd)
    x, y = _batch()
    noise = _zero_grad_params(jt.MLPMixerForImageClassification(**TINY, device="cpu"),
                              {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert noise == {f"model.{i}.0.fn.net.3.bias" for i in range(TINY["depth"])}
    for k in jsd:
        if k not in noise:
            np.testing.assert_allclose(tsd[k], jsd[k], rtol=0, atol=1e-4, err_msg=k)


def _rel_l2(got, want):
    """Global relative L2 error over every parameter."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("route", ["recompute", "kernel"])
def test_bf16_sgd_step_matches_jax(route, monkeypatch):
    """One SGD step at lr 1: the parameter change is the gradient."""
    monkeypatch.setattr(config, "pallas_bwd", route == "kernel")
    init = jm.MLPMixerForImageClassification(**TINY).export_torch_state_dict(tensors=False)
    jl, jsd = _jax_steps(optax.sgd(1.0), 1, compute_dtype=jnp.bfloat16)
    before = dict(tbwd.LAUNCHES)
    tl, tsd = _port_steps(lambda p: torch.optim.SGD(p, lr=1.0), 1, torch.bfloat16)
    assert tbwd.LAUNCHES == before  # CPU tensors run the twins
    assert abs(tl[0] - jl[0]) <= 2e-2 * abs(jl[0]), (tl, jl)
    jg = {k: init[k] - jsd[k] for k in init}
    tg = {k: init[k] - tsd[k] for k in init}
    assert _rel_l2(tg, jg) <= 3e-2, _rel_l2(tg, jg)


def test_cross_entropy_loss_is_f32_mean_nll():
    logits = torch.tensor([[2.0, 0.0, -1.0], [0.5, 0.5, 3.0]], dtype=torch.bfloat16)
    labels = torch.tensor([0, 1])
    want = torch.nn.functional.cross_entropy(logits.float(), labels)
    got = cross_entropy_loss(logits, labels)
    assert got.dtype == torch.float32 and torch.allclose(got, want)


def _interpret(fn, *args):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


FAMILIES = {  # inputs at the block tests' small shapes
    "resmlp": (lambda seed=0: resmlp_inputs(*RESMLP_SHAPES["small"], seed=seed),
               jrb.fused_resmlp_block_trainable, trb.fused_resmlp_block_trainable,
               jrb._plain_resmlp_block, trb.resmlp_block_plain),
    "gmlp": (lambda seed=0: gmlp_inputs(*GMLP_SHAPES["small"], seed=seed),
             jgb.fused_gmlp_block_trainable, tgb.fused_gmlp_block_trainable,
             jgb._plain_gmlp_block, tgb.gmlp_block_plain),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trainable_block_grads_match_jax(family):
    make, jblock, tblock, _, _ = FAMILIES[family]
    x, weights = make()
    args = (x, *weights)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jblock(2, *a) * w)

    with jconfig.parity_mode():
        jl, jg = _interpret(jax.value_and_grad(jloss, argnums=tuple(range(len(args)))),
                            *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tl = (tblock(*targs) * torch.from_numpy(w)).sum()
    tg = torch.autograd.grad(tl, targs)
    assert abs(tl.item() - float(jl)) <= 1e-4 * max(1.0, abs(float(jl)))
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, i
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-4 * max(1.0, np.abs(b).max()), (family, i, err)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_block_matches_jax_in_bf16(family):
    make, _, _, jplain, tplain = FAMILIES[family]
    x, weights = make(seed=3)
    args = (x, *weights)
    want = np.asarray(jplain(*(jnp.asarray(a, jnp.bfloat16) for a in args)).astype(jnp.float32))
    got = tplain(*(torch.from_numpy(a).bfloat16() for a in args))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def _grads(model, batch, dtype):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, dtype)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("route", ["f32", "recompute", "kernel"])
def test_remat_gives_the_same_loss_and_grads(route, monkeypatch):
    """remat_mode() recomputes each block in the backward from the same
    tensors: the loss and every gradient are bit-equal."""
    monkeypatch.setattr(config, "pallas_bwd", route == "kernel")
    dtype = None if route == "f32" else torch.bfloat16
    model = jt.MLPMixerForImageClassification(**TINY, device="cpu")
    x, y = _batch(seed=5)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    l0, g0 = _grads(model, batch, dtype)
    with config.remat_mode():
        l1, g1 = _grads(model, batch, dtype)
    assert torch.equal(l0, l1)
    for k in g0:
        assert g0[k].dtype == torch.float32 and torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("family", ["res_mlp", "g_mlp"])
def test_resmlp_gmlp_train_step_runs_trainable_blocks(family, monkeypatch):
    """A bf16 step of ResMLP / gMLP goes through the trainable wrapper of
    every block and moves every parameter; remat gives the same loss."""
    factory, mod = {"res_mlp": (jt.ResMLPForImageClassification, trb),
                    "g_mlp": (jt.gMLPForImageClassification, tgb)}[family]
    kw = dict(image_size=16, patch_size=8, num_classes=10, depth=2, device="cpu")
    calls = []
    orig = mod.KernelForwardPlainBackward.apply
    monkeypatch.setattr(mod.KernelForwardPlainBackward, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    x, y = _batch(seed=6)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    losses = []
    for remat in (False, True):
        model = factory(**kw)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                               compute_dtype=torch.bfloat16)
        with config.remat_mode() if remat else torch.enable_grad():
            losses.append(float(step(batch)))
        moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
        # ResMLP's final affine is built but never applied (as in the reference)
        unused = {"affine.alpha", "affine.beta"} if family == "res_mlp" else set()
        assert moved == set(before) - unused, set(before) - moved
    assert len(calls) >= 2 * 2 and np.isfinite(losses).all()
    assert losses[0] == losses[1]


def test_step_refuses_int8():
    model = jt.MLPMixerForImageClassification(**TINY, device="cpu")
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                           compute_dtype=torch.bfloat16)
    x, y = _batch()
    with config.int8_mode(), pytest.raises(RuntimeError, match="inference-only"):
        step({"image": torch.from_numpy(x), "label": torch.from_numpy(y)})


def test_buffers_are_not_trained():
    model = jt.MLPMixerForImageClassification(**TINY, device="cpu")
    model.register_buffer("probe", torch.arange(4.0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16)
    x, y = _batch()
    step({"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert model.probe.dtype == torch.float32
    assert torch.equal(model.probe, torch.arange(4.0))
    assert all(p is not model.probe for group in opt.param_groups for p in group["params"])


def test_train_example_prints_finite_losses():
    out = subprocess.run(
        [sys.executable, "-m", "jittor_mlp_tpu_torch.examples.train", "--device", "cpu",
         "--steps", "3", "--image-size", "16", "--batch", "8", "--mixed-precision",
         "--remat", "on"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    losses = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    assert "3 steps in" in out


def test_train_example_trains_as_mlp():
    """AS-MLP-T at 32 px with drop-path from the example's generator."""
    out = subprocess.run(
        [sys.executable, "-m", "jittor_mlp_tpu_torch.examples.train", "--device", "cpu",
         "--model", "AS_MLP", "--steps", "3", "--image-size", "32", "--batch", "4",
         "--mixed-precision"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    losses = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    assert "AS_MLP: 27,521,386 params" in out  # AS-MLP-T with a 10-class head


@pytest.mark.parametrize("model,rate", [("WaveMLP", None), ("MS_MLP", 0.1)],
                         ids=["batchnorm", "drop_path"])
def test_train_example_trains_any_factory(model, rate):
    """WaveMLP-T (BatchNorm, its running statistics updated) and MS-MLP-T
    (its default drop-path rate, 0.1) at 32 px, two steps of two images."""
    out = subprocess.run(
        [sys.executable, "-m", "jittor_mlp_tpu_torch.examples.train", "--device", "cpu",
         "--model", model, "--steps", "2", "--image-size", "32", "--batch", "2"],
        capture_output=True, text=True, timeout=300, check=True).stdout
    losses = [float(line.split()[-1]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    built = getattr(jt, model)(**sized_kwargs(getattr(jt, model), 32, 10), device="cpu")
    assert f"{model}: {built.param_count():,} params" in out
    assert built.stochastic == (rate is not None)


EXPORTED = list(jt.FACTORIES)


@pytest.mark.parametrize("name", EXPORTED)
def test_sized_kwargs_equals_jax(name):
    from jittor_mlp_tpu.utils import sized_kwargs as jax_sized_kwargs

    for size, classes in ((32, 10), (None, 7), (64, None)):
        assert (sized_kwargs(getattr(jt, name), size, classes)
                == jax_sized_kwargs(getattr(jm, name), size, classes))
    assert name in train_example.MODELS


def test_mixer_train_gate_picks_the_route(monkeypatch):
    """bf16 training: the recompute route by default, the kernel route
    under pallas_bwd, each block through its wrapper; eval as before."""
    model = jt.MLPMixerForImageClassification(**TINY, device="cpu").to_bf16()
    bf = torch.zeros(1, dtype=torch.bfloat16)
    calls = []
    for name in ("fused_mixer_block_trainable", "fused_mixer_block_train",
                 "fused_mixer_block"):
        orig = getattr(jt.models.mlp_mixer, name)
        monkeypatch.setattr(jt.models.mlp_mixer, name,
                            lambda *a, _n=name, _f=orig: calls.append(_n) or _f(*a))
    x = torch.from_numpy(_batch()[0]).bfloat16()
    assert model.train().uses_kernel(bf)
    model.forward(x)
    with monkeypatch.context() as m:
        m.setattr(config, "pallas_bwd", True)
        model.forward(x)
    model.eval().forward(x)
    assert calls == (["fused_mixer_block_trainable"] * 2 + ["fused_mixer_block_train"] * 2
                     + ["fused_mixer_block"] * 2)
    assert tmb.LAUNCHES == 0
