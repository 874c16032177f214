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
  single ones, in bf16, with ``compute="int8"`` and with ``weights="int8"``.

The small configurations are those of ``tools/parity_report.py``'s case
list, copied here (its ``build_cases()`` loads the torch reference).
``state_dict_from_jax`` takes the keys the JAX params do not hold
(``convert.jax_dropped``) from the JAX model's init template, as JAX's
export does; every other key must come from the params.
``dyna_xs`` adds its "XS" DynaMixer setting to both packages.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_close

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu import quant as jquant
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch import quant as tquant
from jittor_mlp_tpu_torch.convert import state_dict_from_jax

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


@contextlib.contextmanager
def dyna_xs():
    """The "XS" DynaMixer setting in both packages' ``dynamlp_settings``."""
    from jittor_mlp_tpu.models import dyna_mlp as jdyna
    from jittor_mlp_tpu_torch.models import dyna_mlp as tdyna

    for settings in (jdyna.dynamlp_settings, tdyna.dynamlp_settings):
        settings["XS"] = DYNA_XS
    try:
        yield
    finally:
        for settings in (jdyna.dynamlp_settings, tdyna.dynamlp_settings):
            settings.pop("XS", None)


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def check_same_seed(jax_factory, port_factory, kwargs):
    want = jax_factory(**kwargs)._init_sd
    got = port_factory(**kwargs, **CPU).export_torch_state_dict(tensors=False)
    assert sorted(got) == sorted(want)
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


def check_bf16(jax_factory, port_factory, kwargs, shape):
    x = images(shape, seed=1)
    with jconfig.parity_mode():
        want = np.asarray(jax_factory(**kwargs)(x))
    tmodel = port_factory(**kwargs, **CPU).to_bf16().eval()
    with config.bf16_mode(), torch.inference_mode():
        got = tmodel(x)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


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
        assert got[k].dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].numpy(), err_msg=k)
    return q


def check_predictor(port_factory, kwargs, image_size, opts):
    model = port_factory(**kwargs, **CPU)
    p = jt.Predictor(model, batch_size=4, image_size=image_size, top_k=3, **opts)
    assert p.dtype == ("int8" if opts.get("compute") else "bf16")
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

