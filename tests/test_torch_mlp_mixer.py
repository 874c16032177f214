"""The port's MLP-Mixer against jittor_mlp_tpu's on the CPU.

Same seed → the same weights (both build them with numpy through SDBuilder);
the JAX params pytree converts to the port's state_dict; float32 logits
agree within 1e-4 (conftest.assert_close), the JAX side under parity_mode;
bf16 logits (the port's kernel-gated path, which on the CPU runs the
kernel's plain twin) agree with JAX's plain bf16 path within 2e-2 of
max|logit|.
"""

import jax
import numpy as np
import pytest
import torch
from conftest import assert_close

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb

SMALL = dict(d_model=64, num_classes=10, patch_size=8, image_size=32, depth=2,
             token_dim=24, seed=3)
NON_SQUARE = dict(d_model=32, num_classes=10, patch_size=8, image_size=(32, 64),
                  depth=2, expansion_factor=2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, NON_SQUARE], ids=["small", "non_square"])
def test_same_seed_same_weights(kw):
    jmodel = jm.MLPMixerForImageClassification(**kw)
    tmodel = jt.MLPMixerForImageClassification(**kw, device="cpu")
    want = jmodel._init_sd
    got = tmodel.export_torch_state_dict(tensors=False)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_from_jax_equals_export():
    jmodel = jm.MLPMixerForImageClassification(**SMALL)
    sd = state_dict_from_jax("mlp_mixer", jax.tree.map(np.asarray, jmodel.params))
    want = jmodel.export_torch_state_dict(tensors=False)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    # and it loads strictly into the port
    tmodel = jt.MLPMixerForImageClassification(**{**SMALL, "seed": 9}, device="cpu")
    tmodel.load_torch_state_dict(sd)
    for k, v in tmodel.export_torch_state_dict(tensors=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("kw,shape", [(SMALL, (2, 3, 32, 32)),
                                      (NON_SQUARE, (2, 3, 32, 64))],
                         ids=["small", "non_square"])
def test_f32_logits_match_jax(kw, shape):
    jmodel = jm.MLPMixerForImageClassification(**kw)
    tmodel = jt.MLPMixerForImageClassification(**{**kw, "seed": 5}, device="cpu")
    # through the exporter/importer pair, not the shared seed
    tmodel.load_torch_state_dict(jmodel.export_torch_state_dict())
    x = _x(shape)
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    with jt.config.parity_mode(), torch.inference_mode():
        got = tmodel.eval()(x)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, tol=1e-4, name="mlp_mixer f32")


def test_bf16_logits_match_jax_plain_path():
    jmodel = jm.MLPMixerForImageClassification(**SMALL).to_bf16()
    tmodel = jt.MLPMixerForImageClassification(**SMALL, device="cpu").to_bf16().eval()
    x = _x((4, 3, 32, 32), seed=1)
    with jconfig.bf16_mode():
        want = np.asarray(jmodel(x)).astype(np.float32)
    before = tmb.LAUNCHES
    with jt.config.bf16_mode(), torch.inference_mode():
        assert tmodel.uses_kernel(torch.zeros(1, dtype=torch.bfloat16))
        got = tmodel(x)
    assert got.dtype == torch.bfloat16
    assert tmb.LAUNCHES == before  # CPU tensors run the twin, no launch
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_kernel_gate():
    m = jt.MLPMixerForImageClassification(**SMALL, device="cpu")
    bf = torch.zeros(1, dtype=torch.bfloat16)
    assert m.eval().uses_kernel(bf)
    assert not m.uses_kernel(bf.float())
    assert m.train().uses_kernel(bf)  # bf16 training runs the trainable kernels
    with jt.config.int8_mode():  # ... but not under int8, which a train step refuses
        assert m.eval().uses_kernel(bf) and not m.train().uses_kernel(bf)
    assert not jt.MLPMixerForImageClassification(
        **SMALL, use_pallas=False, device="cpu").eval().uses_kernel(bf)


def test_block_runner_refused():
    with pytest.raises(NotImplementedError):
        jt.MLPMixerForImageClassification(**SMALL, block_runner=lambda *a: None)


@pytest.mark.parametrize("path", ["f32_plain", "bf16_kernel"])
def test_int8_logits_match_jax_int8_mode(path):
    """The port under int8_mode against the JAX int8_mode forward (which on
    the CPU runs its nnf W8A8 path): the plain float32 path quantizes the
    same dense ops; the bf16 path runs the W8A8 block kernel's twin."""
    from jittor_mlp_tpu_torch.ops.kernels import mixer_block_int8 as tq

    jmodel = jm.MLPMixerForImageClassification(**SMALL)
    tmodel = jt.MLPMixerForImageClassification(**SMALL, device="cpu").eval()
    x = _x((4, 3, 32, 32), seed=2)
    with jconfig.int8_mode():
        want = np.asarray(jmodel(x))
    dtype = torch.bfloat16 if path == "bf16_kernel" else torch.float32
    tmodel.to(dtype)
    before = tq.LAUNCHES
    with jt.config.int8_mode(), torch.inference_mode():
        assert tmodel.uses_kernel(torch.zeros(1, dtype=dtype)) == (path == "bf16_kernel")
        got = tmodel.forward(torch.from_numpy(x).to(dtype)).float().numpy()
    assert tq.LAUNCHES == before  # CPU tensors run the twin, no launch
    err = np.abs(got - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err
    with jt.config.parity_mode(), torch.inference_mode():
        exact = tmodel.float()(x).numpy()
    assert np.abs(exact - got).max() > 0  # the int8 path really ran


def test_factory_builds_on_the_card_by_default():
    """device defaults to "cuda": with no card the factory raises instead
    of building on the CPU."""
    if torch.cuda.is_available():
        assert jt.MLPMixerForImageClassification(**SMALL).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jt.MLPMixerForImageClassification(**SMALL)
    assert jt.MLPMixerForImageClassification(**SMALL, device="cpu").device.type == "cpu"
