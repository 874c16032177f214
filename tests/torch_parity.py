"""Shared checks of a port family against the JAX package, on the CPU.

Each check builds the JAX factory and the port's factory with the same
keyword arguments (the port's on ``device="cpu"``) and holds the port to
the JAX package:

- ``check_same_seed``: the same seed gives the same weights bit for bit;
- ``check_convert``: ``state_dict_from_jax`` of the JAX params equals the
  JAX ``export_torch_state_dict()``, and loads strictly;
- ``check_port_parity``: export → ``load_state_dict(strict=True)`` into a
  port model built from another seed, float32 logits within ``tol``
  (conftest.assert_close), the JAX side under ``parity_mode()``;
- ``check_bf16``: the port's bf16 logits within 5e-2 of max|logit| of the
  JAX float32 forward, with the same top-1;
- ``check_int8``: ``int8_mode()`` within 0.1 of max|logit| of the JAX
  ``int8_mode()`` forward, with the same top-1, and away from the exact
  forward (the int8 path ran);
- ``check_int8_state_dict``: the ``weights="int8"`` dequantized state dict
  equals JAX's ``dequantize_tree(quantize_tree(params))`` bit for bit;
- ``check_predictor``: ``Predictor`` answers, and its batched answers equal
  single ones, in bf16, with ``compute="int8"`` and with ``weights="int8"``;
- ``check_block_runner``: a factory's ``block_runner=`` runs each of the
  model's block stacks, and a pass-through runner leaves the float32
  logits as the dense forward's, bit for bit;
- ``check_train_steps``: float32 AdamW steps of the port's
  ``make_train_step`` against the JAX ``make_train_step`` on the same
  weights and batch, losses and the whole exported state dict (running
  statistics included) within 1e-4, both sides under ``parity_mode()``;
  ``fixed_drop_path_masks`` gives both packages' drop-path one mask
  pattern, so that a nonzero rate is held too.

The small configurations are those of ``tools/parity_report.py``'s case
list, copied here (its ``build_cases()`` loads the torch reference).
``state_dict_from_jax`` takes the keys the JAX params do not hold
(``convert.jax_dropped``) from the JAX model's init template, as JAX's
export does; every other key must come from the params.
``dyna_xs``, ``wave_xs``, ``morph_xs`` and ``sequencer_xs`` add the "XS"
settings of DynaMixer, WaveMLP, MorphMLP and Sequencer2D to both
packages (DynaMixer's and MorphMLP's with a drop-path rate, if given). ``calibrated`` gives
the BatchNorm families' factories the running statistics of the JAX
``recalibrate_bn`` on seeded batches, on both sides.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import assert_close

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu import quant as jquant
from jittor_mlp_tpu.parallel.train import make_train_step as jax_train_step
from jittor_mlp_tpu.parallel.train import split_params
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch import quant as tquant
from jittor_mlp_tpu_torch import tuned
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.core import nnf as tnnf
from jittor_mlp_tpu_torch.parallel import make_train_step

CPU = dict(device="cpu")

VIP = dict(image_size=32, patch_size=8, num_classes=10, d_model=32, depth=2, segments=4,
           expansion_factor=2)
S2 = dict(image_size=32, patch_size=[4, 2], num_classes=10, d_model=[32, 64], depth=[2, 2],
          expansion_factor=[2, 2])
RAFT_LAYERS = [{"depth": 1, "dim": 16, "patch_size": 4, "raft_size": 2},
               {"depth": 1, "dim": 32, "patch_size": 2, "raft_size": 2}]
RAFT = dict(layers=RAFT_LAYERS, image_size=16, num_classes=10)
SWIN = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2],
            num_heads=[2, 4], window_size=4, drop_path_rate=0.0)
DYNA = dict(model_name="XS", image_size=32, num_classes=10)
DYNA_XS = [[4, 2], [16, 32], [2, 2], [2, 4], 2, 0.0, 2]
HIRE = dict(patch_size=4, num_classes=10, d_model=[16, 32], h=[4, 3], w=[4, 3],
            cross_region_step=[2, 1], cross_region_interval=2, depth=[2, 3],
            expansion_factor=2)
CYCLE = dict(layers=[1, 2], embed_dims=[16, 32], transitions=[True, True], mlp_ratios=[2, 2],
             num_classes=10)
MS = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2], shift_size=3,
          shift_dist=[-1, 0, 1], mix_size=[[1, 3, 5], [1, 3, 3]], drop_path_rate=0.0)
ACTIVE = dict(depths=[2, 2], embed_dims=[16, 32], mlp_ratios=[2, 2], share_dims=[2, 4], intv=2,
              num_classes=10)
CONV_MIXER = dict(dim=32, depth=3, kernel_size=5, patch_size=4, n_classes=10)
CONV_MLP = dict(depth=[1, 2], d_model=[32, 64], expansion_factor=[2, 2], channels=16,
                n_conv_blocks=2, num_classes=10)
SPARSE = dict(image_size=32, patch_size=4, num_classes=10, d_model=16, depth=[2, 2],
              expansion_factor=2)
REPMLP = dict(in_channels=3, num_class=10, patch_size=(2, 2), num_blocks=(1, 2), channels=(8, 16),
              hs=(4, 2), ws=(4, 2), sharesets_nums=(2, 4), reparam_conv_k=(1, 3))
WAVE = dict(model_name="XS", num_classes=10)
WAVE_XS = [[1, 1, 1, 1], [2, 2, 2, 2]]
MORPH = dict(model_name="XS", num_classes=10)
MORPH_XS = [[2, 2], [2, 2], [16, 32], [4, 4], [0.0, 0.0]]
SEQ = dict(model_name="XS", num_classes=10)
SEQ_XS = [[1, 1], [16, 32], [8, 8], 2]


@contextlib.contextmanager
def _xs(module, table, setting):
    """``setting`` as "XS" in the settings ``table`` of model ``module`` in
    both packages."""
    import importlib

    tables = [getattr(importlib.import_module(f"{pkg}.models.{module}"), table)
              for pkg in ("jittor_mlp_tpu", "jittor_mlp_tpu_torch")]
    old = [settings.get("XS") for settings in tables]  # another test may have set one
    for settings in tables:
        settings["XS"] = setting
    try:
        yield
    finally:
        for settings, value in zip(tables, old):
            if value is None:
                settings.pop("XS", None)
            else:
                settings["XS"] = value


def dyna_xs(drop_path=0.0):
    """The "XS" DynaMixer setting in both packages' ``dynamlp_settings``,
    its drop-path rate ``drop_path``."""
    return _xs("dyna_mlp", "dynamlp_settings", DYNA_XS[:5] + [drop_path] + DYNA_XS[6:])


def wave_xs():
    """The "XS" WaveMLP setting (tools/parity_report.py) in both packages."""
    return _xs("wave_mlp", "wavemlp_settings", WAVE_XS)


def morph_xs(stoch_drop=0.0):
    """The "XS" MorphMLP setting (tools/parity_report.py) in both packages,
    each stage's drop-path rate ``stoch_drop``."""
    return _xs("morph_mlp", "morphmlp_settings", MORPH_XS[:4] + [[stoch_drop] * 2])


def sequencer_xs():
    """The "XS" Sequencer2D setting (tools/parity_report.py) in both
    packages."""
    return _xs("sequencer", "sequencer_settings", SEQ_XS)


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


_CALIBRATED = {}


def calibrated(jax_factory, port_factory, shape, n_batches=2):
    """(JAX factory, port factory) whose models carry the running
    statistics that the JAX ``recalibrate_bn`` gives on ``n_batches``
    seeded batches of ``shape``, for the BatchNorm families (at seed 0's
    mean 0 and var 1 their eval forward grows without bound, and a band
    would measure nothing). The statistics are made once per
    configuration and loaded into either side through the JAX export."""
    from jittor_mlp_tpu.core.train_utils import recalibrate_bn

    def state(kw):
        kw = {k: v for k, v in kw.items() if k not in ("seed", "device")}
        key = (jax_factory, repr(sorted(kw.items())))
        if key not in _CALIBRATED:
            jmodel = recalibrate_bn(jax_factory(**kw), [images(shape, seed=20 + i)
                                                        for i in range(n_batches)])
            _CALIBRATED[key] = jmodel.export_torch_state_dict(tensors=False)
        return _CALIBRATED[key]

    def jax_f(**kw):
        return jax_factory(**kw).load_torch_state_dict(state(kw))

    def port_f(**kw):
        return port_factory(**kw).load_torch_state_dict(state(kw))

    return jax_f, port_f


def check_same_seed(jax_factory, port_factory, kwargs):
    """The keys both sides hold: the JAX init template has no BatchNorm
    ``num_batches_tracked``, which the port holds as int64 0."""
    want = jax_factory(**kwargs)._init_sd
    got = port_factory(**kwargs, **CPU).export_torch_state_dict(tensors=False)
    counters = {k for k in got if k.endswith(".num_batches_tracked")}
    assert sorted(set(got) - counters) == sorted(want)
    for k in counters:
        assert got[k].dtype == np.int64 and got[k] == 0, k
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def check_convert(name, jax_factory, port_factory, kwargs):
    jmodel = jax_factory(**kwargs)
    sd = state_dict_from_jax(name, jax.tree.map(np.asarray, jmodel.params),
                             template=jmodel._init_sd)
    want = jmodel.export_torch_state_dict(tensors=False)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    tmodel = port_factory(**{**kwargs, "seed": 9}, **CPU)
    tmodel.load_state_dict(sd, strict=True)
    for k, v in tmodel.export_torch_state_dict(tensors=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def check_port_parity(jax_factory, port_factory, kwargs, shape, tol=1e-4, name=""):
    """Float32 logits of the port, loaded from the JAX export, against the
    JAX forward under parity_mode(). Returns the port's logits."""
    jmodel = jax_factory(**kwargs)
    tmodel = port_factory(**{**kwargs, "seed": 5}, **CPU).eval()
    tmodel.load_state_dict(
        {k: torch.from_numpy(v) for k, v in
         jmodel.export_torch_state_dict(tensors=False).items()}, strict=True)
    x = images(shape)
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    with config.parity_mode(), torch.inference_mode():
        got = tmodel(x)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, tol=tol, name=f"{name} f32")
    return got.numpy()


def check_bf16(jax_factory, port_factory, kwargs, shape, exempt_ties=False):
    """With ``exempt_ties``, an image whose two top float32 logits lie
    closer than twice the measured deviation may change its top-1 (the
    band allows it; the JAX bf16 forward flips such near ties too); the
    rest must keep theirs."""
    x = images(shape, seed=1)
    with jconfig.parity_mode():
        want = np.asarray(jax_factory(**kwargs)(x))
    tmodel = port_factory(**kwargs, **CPU).to_bf16().eval()
    with config.bf16_mode(), torch.inference_mode():
        got = tmodel(x)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    dev = np.abs(got - want).max()
    assert dev <= 5e-2 * np.abs(want).max()
    top2 = np.sort(want, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * dev if exempt_ties else np.ones(len(want), bool)
    assert decided.mean() >= 0.75, f"{(~decided).sum()} of {len(want)} images are near ties"
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def check_int8(jax_factory, port_factory, kwargs, shape):
    x = images(shape, seed=2)
    with jconfig.parity_mode(), jconfig.int8_mode():
        want = np.asarray(jax_factory(**kwargs)(x))
    tmodel = port_factory(**kwargs, **CPU).eval()
    with config.parity_mode(), config.int8_mode(), torch.inference_mode():
        got = tmodel(x).numpy()
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    with config.parity_mode(), torch.inference_mode():
        exact = tmodel(x).numpy()
    assert np.abs(exact - got).max() > 0  # the int8 path really ran


def check_int8_state_dict(name, jax_factory, port_factory, kwargs, dtype="float32"):
    """Returns the port's int8 state dict (key → {"q", "scale"} or tensor)."""
    jmodel = jax_factory(**kwargs)
    jdq = jquant.dequantize_tree(
        jquant.quantize_tree(jax.tree.map(np.asarray, jmodel.params)), getattr(jnp, dtype))
    template = {k: np.asarray(jnp.asarray(v, getattr(jnp, dtype)), np.float32)
                for k, v in jmodel._init_sd.items()}  # as dequantize_tree casts a kept leaf
    want = state_dict_from_jax(name, jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jdq), template=template)
    q = tquant.quantize_state_dict(name, port_factory(**kwargs, **CPU).state_dict())
    got = tquant.dequantize_state_dict(q, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for k in want:
        # num_batches_tracked stays int64, as in JAX's export
        assert got[k].dtype == (getattr(torch, dtype) if want[k].is_floating_point()
                                else torch.int64), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].float().numpy(), err_msg=k)
    return q


def check_predictor(port_factory, kwargs, image_size, opts):
    model = port_factory(**kwargs, **CPU)
    p = jt.Predictor(model, batch_size=4, image_size=image_size, top_k=3, **opts)
    # the default dtype is the model's row of the port's tuned.SERVE (bf16
    # without one); compute="int8" serves int8, and weights="int8" an int8
    # row's dtype in bf16
    row = tuned.serve_settings(model.name)
    default = row["dtype"] if row else "bf16"
    want = ("int8" if opts.get("compute") else
            "bf16" if default == "int8" and opts.get("weights") else default)
    assert p.dtype == want
    imgs = np.random.default_rng(4).integers(0, 256, (4, image_size, image_size, 3),
                                             dtype=np.uint8)
    labels, probs = p.predict(imgs)
    assert labels.shape == probs.shape == (4, 3) and np.isfinite(probs).all()
    for i in range(4):
        li, pi = p.predict(imgs[i:i + 1])
        np.testing.assert_array_equal(li[0], labels[i])
        np.testing.assert_allclose(pi[0], probs[i], rtol=0, atol=1e-6)


PREDICTOR_OPTS = [{}, {"compute": "int8"}, {"weights": "int8"}]
PREDICTOR_IDS = ["bf16", "compute_int8", "weights_int8"]


def check_factory_device(port_factory, kwargs):
    """device defaults to "cuda": with no card the factory raises instead
    of building on the CPU; device="cpu" builds there."""
    if torch.cuda.is_available():
        assert port_factory(**kwargs).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_factory(**kwargs)
    assert port_factory(**kwargs, **CPU).device.type == "cpu"



def check_block_runner(port_factory, kwargs, image_size, stacks):
    """``port_factory(..., block_runner=runner)`` runs its ``stacks`` block
    stacks through ``runner`` (a pass-through that records them), and its
    float32 logits on two seeded images equal the dense model's bit for
    bit."""
    seen = []

    def runner(fn, blocks, x):
        seen.append(len(blocks))
        for blk in blocks:
            x = fn(blk, x)
        return x

    x = torch.from_numpy(images((2, 3, image_size, image_size)))
    with torch.no_grad():
        want = port_factory(**kwargs, **CPU).eval()(x)
        model = port_factory(**kwargs, block_runner=runner, **CPU)
        got = model.eval()(x)
    assert model.block_runner is runner
    assert len(seen) == stacks, seen
    assert torch.equal(got, want)


def fixed_drop_path_masks(monkeypatch):
    """Every drop-path mask of both packages, for the rest of the test: the
    even samples kept, the odd ones dropped. The JAX ``nnf.drop_path``
    draws ``jax.random.bernoulli(rng, keep, shape)``: where keep < 1 the
    pattern, else all kept (a rate-0 site); the port draws through
    ``nnf.drop_path_mask`` at sites whose rate is above 0 only. A scalar
    draw (shape None or (), as the JAX recipe's mode coin) goes to the
    original ``jax.random.bernoulli``."""
    original = jax.random.bernoulli

    def bernoulli(key, p=0.5, shape=None):
        if shape is None or tuple(shape) == ():
            return original(key, p, shape)
        keep = (jnp.arange(shape[0]) % 2 == 0).reshape((-1,) + (1,) * (len(shape) - 1))
        return jnp.where(jnp.asarray(p) < 1, jnp.broadcast_to(keep, shape), True)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(tnnf, "drop_path_mask",
                        lambda batch, rate, generator, device:
                        torch.arange(batch, device=device) % 2 == 0)


def train_batch(shape, num_classes=10, seed=0):
    r = np.random.default_rng(seed)
    return {"image": torch.from_numpy(r.standard_normal(shape).astype(np.float32)),
            "label": torch.from_numpy(r.integers(0, num_classes, shape[0]))}


def check_train_steps(jax_factory, port_factory, kwargs, shape, steps=2, lr=1e-2, eps=1e-4):
    """``steps`` float32 AdamW(lr) steps on one seeded batch of ``shape``:
    the JAX ``make_train_step`` (optax ``adamw``, rng PRNGKey(s) at step s)
    against the port's (``torch.optim.AdamW`` with optax's decay 1e-4, a
    generator seeded s), on the same seed's weights, both under
    ``parity_mode()``. Losses, and the whole exported state dict (running
    statistics and ``num_batches_tracked`` included) within atol 1e-4.
    Both take Adam's ``eps`` 1e-4, not the default 1e-8: a bias that only
    feeds a train-mode BatchNorm has a zero gradient (the BatchNorm takes
    its mean out), which float32 leaves at up to 5e-8, and eps 1e-8 turns
    that rounding into a ±lr step that no two implementations share
    (MorphMLP's stem bias moved 0.027 apart in two steps; 1.2e-4 at eps
    1e-5). At 1e-4 such a step is under 5e-4 of lr, and the gradients of
    these models (median 3e-3) keep Adam's full scale. Returns the port's
    model and losses."""
    b = train_batch(shape)
    jmodel = jax_factory(**kwargs)
    params = jax.tree.map(jnp.array, jmodel.params)  # the step donates its params
    opt = optax.adamw(lr, eps=eps)
    opt_state = opt.init(split_params(params)[0])
    jstep = jax_train_step(jmodel.apply, opt)
    batch = {"image": jnp.asarray(b["image"].numpy()), "label": jnp.asarray(b["label"].numpy())}
    want = []
    with jconfig.parity_mode():
        for s in range(steps):
            params, opt_state, loss = jstep(params, opt_state, batch, jax.random.PRNGKey(s))
            want.append(float(loss))
    jmodel.params = params
    jsd = jmodel.export_torch_state_dict(tensors=False)
    model = port_factory(**kwargs, **CPU)
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=lr,
                                                    weight_decay=1e-4, eps=eps))
    with config.parity_mode():
        got = [float(step(b, torch.Generator().manual_seed(s))) for s in range(steps)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    tsd = model.export_torch_state_dict(tensors=False)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=0, atol=1e-4, err_msg=k)
    return model, got
