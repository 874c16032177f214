"""The port's AS-MLP against jittor_mlp_tpu's, on the CPU.

The JAX factory is the reference (tests/test_as_mlp.py loads the torch
reference checkout instead, which these tests never do), at the configs of
tests/test_as_mlp.py: SMALL (img 32, embed 16, depths [2, 2], shift 3) and
NO_BIAS (embed 20, depths [2], shift 3, as_bias=False: ragged groups of
7, 7, 6 channels), both at drop_path_rate 0.

- Weights: the same seed gives the same weights bit for bit, and
  ``state_dict_from_jax`` of the JAX params equals the export.
- float32 logits within 1e-4 (conftest.assert_close), the JAX side under
  parity_mode, through identical init and through export → load.
- bf16 logits (the shift through the kernel wrapper, its twin on the CPU,
  and the plain path) against the JAX float32 forward: within 5e-2 of
  max|logit| and the same top-1. int8_mode() against the JAX int8_mode()
  forward within 0.1 of max|logit| (tests/test_int8.py:170-173) and the
  same top-1.
- weights="int8": the dequantized AS-MLP-T state dict equals the JAX
  ``dequantize_tree(quantize_tree(params))`` bit for bit; stage 2's stacked
  GroupNorm weights (6, 384) are quantized with one scale per layer,
  stage 0's (2, 96) are not.
- Training: three float32 AdamW steps through ``make_train_step`` against
  the JAX step (losses and parameters within 1e-4); one bf16 step; the
  drop-path generator, remat and ``use_checkpoint``.
- Serving: ``Predictor`` in bf16, compute="int8" and weights="int8";
  batched answers equal single-image ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import assert_close

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu import quant as jquant
from jittor_mlp_tpu.parallel.train import make_train_step as jax_train_step
from jittor_mlp_tpu.parallel.train import split_params
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch import quant as tquant
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.ops.kernels import axial_shift as tks
from jittor_mlp_tpu_torch.parallel import loss_fn, make_train_step

SMALL = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2],
             shift_size=3, drop_path_rate=0.0)
NO_BIAS = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=20, depths=[2],
               shift_size=3, as_bias=False, drop_path_rate=0.0)
CONFIGS = pytest.mark.parametrize("kw", [SMALL, NO_BIAS], ids=["small", "no_bias"])
CPU = dict(device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _batch(n=4, seed=0):
    r = np.random.default_rng(seed)
    return {"image": torch.from_numpy(r.standard_normal((n, 3, 32, 32)).astype(np.float32)),
            "label": torch.from_numpy(r.integers(0, 10, n))}


@pytest.mark.parametrize("kw", [SMALL, NO_BIAS, {}], ids=["small", "no_bias", "as_mlp_t"])
def test_same_seed_same_weights(kw):
    want = jm.AS_MLP(**kw)._init_sd
    got = jt.AS_MLP(**kw, **CPU).export_torch_state_dict(tensors=False)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not kw:  # AS-MLP-T: the factory's defaults
        assert sum(v.size for v in got.values()) == 28_282_696
        assert got["layers.2.blocks.5.axial_shift.conv1.weight"].shape == (384, 384, 1, 1)
        assert "layers.3.downsample.norm.weight" not in got


@CONFIGS
def test_state_dict_from_jax_equals_export(kw):
    jmodel = jm.AS_MLP(**kw)
    sd = state_dict_from_jax("as_mlp", jax.tree.map(np.asarray, jmodel.params))
    want = jmodel.export_torch_state_dict(tensors=False)
    assert sorted(sd) == sorted(want)  # the stacked drop-path rates are dropped
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    tmodel = jt.AS_MLP(**{**kw, "seed": 9}, **CPU)
    tmodel.load_state_dict(sd, strict=True)
    for k, v in tmodel.export_torch_state_dict(tensors=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@CONFIGS
@pytest.mark.parametrize("init", ["same_seed", "export_load"])
def test_f32_logits_match_jax(kw, init):
    jmodel = jm.AS_MLP(**kw)
    if init == "same_seed":
        tmodel = jt.AS_MLP(**kw, **CPU)
    else:
        tmodel = jt.AS_MLP(**{**kw, "seed": 5}, **CPU)
        tmodel.load_state_dict(
            {k: torch.from_numpy(v) for k, v in
             jmodel.export_torch_state_dict(tensors=False).items()}, strict=True)
    x = _x((2, 3, 32, 32))
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    with config.parity_mode(), torch.inference_mode():
        got = tmodel.eval()(x)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, tol=1e-4, name="as_mlp f32")


@CONFIGS
@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_wrapper", "plain"])
def test_bf16_logits_within_band_of_jax_f32(kw, use_pallas):
    x = _x((8, 3, 32, 32), seed=1)
    with jconfig.parity_mode():
        want = np.asarray(jm.AS_MLP(**kw)(x))
    tmodel = jt.AS_MLP(**kw, use_pallas=use_pallas, **CPU).to_bf16().eval()
    before = tks.LAUNCHES
    with config.bf16_mode(), torch.inference_mode():
        got = tmodel(x)
    assert got.dtype == torch.bfloat16
    assert tks.LAUNCHES == before  # CPU tensors run the twin
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw):
    x = _x((8, 3, 32, 32), seed=2)
    jmodel = jm.AS_MLP(**kw)
    with jconfig.parity_mode(), jconfig.int8_mode():
        want = np.asarray(jmodel(x))
    tmodel = jt.AS_MLP(**kw, **CPU).eval()
    with config.parity_mode(), config.int8_mode(), torch.inference_mode():
        got = tmodel(x).numpy()
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    with config.parity_mode(), torch.inference_mode():
        exact = tmodel(x).numpy()
    assert np.abs(exact - got).max() > 0  # the int8 path really ran


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    """AS-MLP-T (weights only, no forward): the JAX rule on per-stage
    stacked leaves."""
    jmodel = jm.AS_MLP()
    jdq = jquant.dequantize_tree(
        jquant.quantize_tree(jax.tree.map(np.asarray, jmodel.params)), getattr(jnp, dtype))
    want = state_dict_from_jax("as_mlp", jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jdq))
    q = tquant.quantize_state_dict("as_mlp", jt.AS_MLP(**CPU).state_dict())
    got = tquant.dequantize_state_dict(q, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].numpy(), err_msg=k)
    # stage 2: six blocks of 384 channels, 2,304 GroupNorm weights stacked
    gn2 = q["layers.2.blocks.3.norm1.weight"]
    assert isinstance(gn2, dict) and gn2["scale"].numel() == 1
    assert not isinstance(q["layers.0.blocks.1.norm1.weight"], dict)  # (2, 96): too few
    conv = q["layers.1.blocks.0.axial_shift.conv1.weight"]  # (2, 192, 192, 1, 1) stacked
    assert conv["scale"].shape == (192, 1, 1, 1)
    assert q["layers.0.downsample.reduction.weight"]["scale"].shape == (192, 1, 1, 1)


def _jax_steps(kw, opt, n_steps):
    jmodel = jm.AS_MLP(**kw)
    params = jax.tree.map(jnp.array, jmodel.params)  # the step donates its params
    train, _, _, _ = split_params(params)
    opt_state = opt.init(train)
    step = jax_train_step(jmodel.apply, opt)
    b = _batch()
    batch = {"image": jnp.asarray(b["image"].numpy()), "label": jnp.asarray(b["label"].numpy())}
    losses = []
    for s in range(n_steps):
        params, opt_state, loss = step(params, opt_state, batch, jax.random.PRNGKey(s))
        losses.append(float(loss))
    jmodel.params = params
    return losses, jmodel.export_torch_state_dict(tensors=False)


def test_f32_adamw_steps_match_jax():
    with jconfig.parity_mode():
        jl, jsd = _jax_steps(SMALL, optax.adamw(1e-2), 3)
    model = jt.AS_MLP(**SMALL, **CPU)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(model, opt)
    with config.parity_mode():
        tl = [float(step(_batch(), torch.Generator().manual_seed(s))) for s in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl[-1] < tl[0]
    tsd = model.export_torch_state_dict(tensors=False)
    assert list(tsd) == list(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=0, atol=1e-4, err_msg=k)


def _loss(model, dtype=None, generator=None, seed=0):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, _batch(seed=seed), dtype, generator)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_bf16_step_runs_and_moves_every_parameter():
    model = jt.AS_MLP(**{**SMALL, "drop_path_rate": 0.2}, **CPU)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                           compute_dtype=torch.bfloat16)
    loss = float(step(_batch(), torch.Generator().manual_seed(0)))
    assert np.isfinite(loss)
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert moved == set(before)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_drop_path_follows_the_generator_and_survives_remat(dtype):
    """The same generator seed gives the same loss and gradients, with or
    without checkpointing (the masks are drawn before the blocks run), and
    use_checkpoint is the same as remat_mode(); another seed, or none,
    gives another loss."""
    kw = {**SMALL, "drop_path_rate": 0.5}
    model = jt.AS_MLP(**kw, **CPU)
    l0, g0 = _loss(model, dtype, torch.Generator().manual_seed(1))
    with config.remat_mode():
        l1, g1 = _loss(model, dtype, torch.Generator().manual_seed(1))
    ckpt = jt.AS_MLP(**kw, use_checkpoint=True, **CPU)
    l2, g2 = _loss(ckpt, dtype, torch.Generator().manual_seed(1))
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    for k in g0:
        assert torch.equal(g0[k], g1[k]) and torch.equal(g0[k], g2[k]), k
    l3, _ = _loss(model, dtype, torch.Generator().manual_seed(2))
    l4, _ = _loss(model, dtype, None)
    assert len({float(l0), float(l3), float(l4)}) == 3
    model.eval()  # eval ignores the generator
    with torch.no_grad():
        x = _batch()["image"]
        assert torch.equal(model.forward(x, torch.Generator().manual_seed(1)), model.forward(x))


def test_shift_moves_the_logits():
    """shift_size=1 makes every shift the identity (one group, s = 0): the
    real shift must move the logits far more than the bf16 band."""
    x = _x((2, 3, 32, 32), seed=3)
    with torch.inference_mode():
        full = jt.AS_MLP(**SMALL, **CPU).eval()(x)
        ident = jt.AS_MLP(**{**SMALL, "shift_size": 1}, **CPU).eval()(x)
    assert (full - ident).abs().max().item() > 0.1 * full.abs().max().item()


def test_factory_options():
    with pytest.raises(NotImplementedError):
        jt.AS_MLP(**SMALL, block_runner=lambda *a: None, **CPU)
    m = jt.AS_MLP(**{**SMALL, "drop_path_rate": 0.3}, drop_rate=0.5, **CPU)
    rates = [blk.drop_path_rate for layer in m.layers for blk in layer.blocks]
    np.testing.assert_array_equal(rates, np.linspace(0, 0.3, 4, dtype=np.float32))
    assert m.layers[-1].downsample is None and m.layers[0].downsample is not None
    assert jt.AS_MLP(**SMALL, patch_norm=False, **CPU).patch_embed.norm is None


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("opts", [{}, {"compute": "int8"}, {"weights": "int8"}],
                         ids=["bf16", "compute_int8", "weights_int8"])
def test_predictor_batched_equals_alone(opts):
    p = jt.Predictor(jt.AS_MLP(**SMALL, **CPU), batch_size=4, image_size=32, top_k=3, **opts)
    assert p.dtype == ("int8" if opts.get("compute") else "bf16")
    imgs = _images(4, seed=4)
    labels, probs = p.predict(imgs)
    assert labels.shape == probs.shape == (4, 3) and np.isfinite(probs).all()
    for i in range(4):
        li, pi = p.predict(imgs[i:i + 1])
        np.testing.assert_array_equal(li[0], labels[i])
        np.testing.assert_allclose(pi[0], probs[i], rtol=0, atol=1e-6)


def test_predictor_f32_weights_int8_matches_jax():
    jp = jm.Predictor(jm.AS_MLP(**SMALL), batch_size=4, image_size=32, top_k=3, bf16=False,
                      weights="int8")
    tp = jt.Predictor(jt.AS_MLP(**SMALL, **CPU), batch_size=4, image_size=32, top_k=3,
                      bf16=False, weights="int8")
    imgs = _images(4, seed=5)
    jl, jprob = jp.predict(imgs)
    tl, tprob = tp.predict(imgs)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
