"""The port's gMLP against jittor_mlp_tpu's on the CPU.

Same seed → the same weights (both build them with numpy through SDBuilder,
in the same order, the spatial bias at 1.0); the JAX params pytree
converts to the port's state_dict; float32 logits agree within 1e-4
(conftest.assert_close), the JAX side under parity_mode; bf16 logits (the
port's kernel-gated path, which on the CPU runs the kernel's plain twin)
agree with JAX's plain bf16 path within 2e-2 of max|logit|; int8 logits
agree with the JAX ``int8_mode()`` forward within 5e-2 of max|logit|, on
the port's plain float32 path and on its bf16 W8A8 kernel path (twin on
the CPU).
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
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block as tgb
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block_int8 as tgq

SMALL = dict(d_model=48, d_ffn=96, num_classes=10, patch_size=8, image_size=32, depth=3,
             seed=3)
NON_SQUARE = dict(d_model=32, d_ffn=48, num_classes=10, patch_size=8, image_size=(32, 64),
                  depth=2)
NARROW = dict(d_model=16, d_ffn=32, num_classes=10, patch_size=8, image_size=32, depth=4)
CPU = dict(device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, NON_SQUARE, NARROW], ids=["small", "non_square", "narrow"])
def test_same_seed_same_weights(kw):
    jmodel = jm.gMLPForImageClassification(**kw)
    tmodel = jt.gMLPForImageClassification(**kw, **CPU)
    want = jmodel._init_sd
    got = tmodel.export_torch_state_dict(tensors=False)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.all(got["model.0.sgu.spatial_proj.bias"] == np.float32(1.0))
    n = tmodel.num_patches
    assert got["model.0.sgu.spatial_proj.weight"].shape == (n, n, 1)


def test_state_dict_from_jax_equals_export():
    jmodel = jm.gMLPForImageClassification(**SMALL)
    sd = state_dict_from_jax("g_mlp", jax.tree.map(np.asarray, jmodel.params))
    want = jmodel.export_torch_state_dict(tensors=False)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    tmodel = jt.gMLPForImageClassification(**{**SMALL, "seed": 9}, **CPU)
    tmodel.load_torch_state_dict(sd)
    for k, v in tmodel.export_torch_state_dict(tensors=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("kw,shape", [(SMALL, (2, 3, 32, 32)), (NON_SQUARE, (2, 3, 32, 64)),
                                      (NARROW, (3, 3, 32, 32))],
                         ids=["small", "non_square", "narrow"])
def test_f32_logits_match_jax(kw, shape):
    jmodel = jm.gMLPForImageClassification(**kw)
    tmodel = jt.gMLPForImageClassification(**{**kw, "seed": 5}, **CPU)
    tmodel.load_torch_state_dict(jmodel.export_torch_state_dict())
    x = _x(shape)
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    with jt.config.parity_mode(), torch.inference_mode():
        got = tmodel.eval()(x)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, tol=1e-4, name="g_mlp f32")


def test_bf16_logits_match_jax_plain_path():
    jmodel = jm.gMLPForImageClassification(**SMALL).to_bf16()
    tmodel = jt.gMLPForImageClassification(**SMALL, **CPU).to_bf16().eval()
    plain = jt.gMLPForImageClassification(**SMALL, use_pallas=False, **CPU).to_bf16().eval()
    x = _x((4, 3, 32, 32), seed=1)
    with jconfig.bf16_mode():
        want = np.asarray(jmodel(x)).astype(np.float32)
    before = tgb.LAUNCHES
    with jt.config.bf16_mode(), torch.inference_mode():
        assert tmodel.uses_kernel(torch.zeros(1, dtype=torch.bfloat16))
        got = tmodel(x)
        got_plain = plain(x)
    assert got.dtype == torch.bfloat16
    assert tgb.LAUNCHES == before  # CPU tensors run the twin, no launch
    for out in (got, got_plain):
        err = np.abs(out.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("path", ["f32_plain", "bf16_kernel"])
def test_int8_logits_match_jax_int8_mode(path):
    jmodel = jm.gMLPForImageClassification(**SMALL)
    tmodel = jt.gMLPForImageClassification(**SMALL, **CPU).eval()
    x = _x((4, 3, 32, 32), seed=2)
    with jconfig.int8_mode():
        want = np.asarray(jmodel(x))
    dtype = torch.float32
    if path == "bf16_kernel":
        tmodel.to_bf16()
        dtype = torch.bfloat16
    before = tgq.LAUNCHES
    with jt.config.int8_mode(), torch.inference_mode():
        assert tmodel.uses_kernel(torch.zeros(1, dtype=dtype)) == (path == "bf16_kernel")
        got = tmodel.forward(torch.from_numpy(x).to(dtype)).float().numpy()
    assert tgq.LAUNCHES == before
    err = np.abs(got - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err
    with jt.config.parity_mode(), torch.inference_mode():
        exact = tmodel.float()(x).numpy()
    assert np.abs(exact - got).max() > 0  # the int8 path really ran


def test_blocks_move_the_logits():
    """With channel_proj2 zeroed every block is the identity; the real
    blocks must move the logits far more than the bf16 path's error."""
    m = jt.gMLPForImageClassification(**SMALL, **CPU).eval()
    x = torch.from_numpy(_x((2, 3, 32, 32), seed=3))
    with torch.inference_mode():
        full = m(x)
        for blk in m.model:
            blk.channel_proj2.weight.zero_()
            blk.channel_proj2.bias.zero_()
        ident = m(x)
    assert (full - ident).abs().max().item() > 0.1 * full.abs().max().item()


def test_kernel_gate_and_options():
    m = jt.gMLPForImageClassification(**SMALL, **CPU)
    bf = torch.zeros(1, dtype=torch.bfloat16)
    assert m.eval().uses_kernel(bf)
    assert not m.uses_kernel(bf.float())
    assert m.train().uses_kernel(bf)  # bf16 training runs the trainable kernels
    with jt.config.int8_mode():  # ... but not under int8, which a train step refuses
        assert m.eval().uses_kernel(bf) and not m.train().uses_kernel(bf)
    assert not jt.gMLPForImageClassification(
        **SMALL, use_pallas=False, **CPU).eval().uses_kernel(bf)
    with pytest.raises(NotImplementedError):
        jt.gMLPForImageClassification(**SMALL, block_runner=lambda *a: None, **CPU)
    # the factory's defaults are the JAX factory's (gMLP-S @256)
    d = jt.gMLPForImageClassification(depth=1, **CPU)
    assert (d.num_patches, d.d_model, d.patch_size) == (256, 256, 16)
    assert d.model[0].channel_proj1.weight.shape == (2 * 1536, 256)
