"""The port's ResMLP against jittor_mlp_tpu's on the CPU.

Same seed → the same weights (both build them with numpy through SDBuilder,
γ by depth); the JAX params pytree converts to the port's state_dict;
float32 logits agree within 1e-4 (conftest.assert_close), the JAX side
under parity_mode; bf16 logits (the port's kernel-gated path, which on the
CPU runs the kernel's plain twin) agree with JAX's plain bf16 path within
2e-2 of max|logit|; int8 logits agree with the JAX ``int8_mode()`` forward
within 5e-2 of max|logit|, on the port's plain float32 path and on its
bf16 W8A8 kernel path (twin on the CPU). γ is 0.1 at these depths, so the
blocks move the logits.
"""

import jax
import numpy as np
import pytest
import torch
from conftest import assert_close
import torch_parity as tp

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block as trb
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block_int8 as trq

SMALL = dict(d_model=48, num_classes=10, patch_size=8, image_size=32, depth=3, seed=3)
NON_SQUARE = dict(d_model=32, num_classes=10, patch_size=8, image_size=(32, 64),
                  depth=2, expansion_factor=2)
DEEP = dict(d_model=16, num_classes=10, patch_size=8, image_size=32, depth=20)
CPU = dict(device="cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, NON_SQUARE, DEEP], ids=["small", "non_square", "deep"])
def test_same_seed_same_weights(kw):
    jmodel = jm.ResMLPForImageClassification(**kw)
    tmodel = jt.ResMLPForImageClassification(**kw, **CPU)
    want = jmodel._init_sd
    got = tmodel.export_torch_state_dict(tensors=False)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    gamma = {3: 0.1, 2: 0.1, 20: 1e-5}[kw["depth"]]
    assert np.all(got["model.0.gamma_1"] == np.float32(gamma))


def test_state_dict_from_jax_equals_export():
    jmodel = jm.ResMLPForImageClassification(**SMALL)
    sd = state_dict_from_jax("res_mlp", jax.tree.map(np.asarray, jmodel.params))
    want = jmodel.export_torch_state_dict(tensors=False)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)
    tmodel = jt.ResMLPForImageClassification(**{**SMALL, "seed": 9}, **CPU)
    tmodel.load_torch_state_dict(sd)
    for k, v in tmodel.export_torch_state_dict(tensors=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("kw,shape", [(SMALL, (2, 3, 32, 32)), (NON_SQUARE, (2, 3, 32, 64))],
                         ids=["small", "non_square"])
def test_f32_logits_match_jax(kw, shape):
    jmodel = jm.ResMLPForImageClassification(**kw)
    tmodel = jt.ResMLPForImageClassification(**{**kw, "seed": 5}, **CPU)
    tmodel.load_torch_state_dict(jmodel.export_torch_state_dict())
    x = _x(shape)
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    with jt.config.parity_mode(), torch.inference_mode():
        got = tmodel.eval()(x)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, tol=1e-4, name="res_mlp f32")


def test_bf16_logits_match_jax_plain_path():
    jmodel = jm.ResMLPForImageClassification(**SMALL).to_bf16()
    tmodel = jt.ResMLPForImageClassification(**SMALL, **CPU).to_bf16().eval()
    plain = jt.ResMLPForImageClassification(**SMALL, use_pallas=False, **CPU).to_bf16().eval()
    x = _x((4, 3, 32, 32), seed=1)
    with jconfig.bf16_mode():
        want = np.asarray(jmodel(x)).astype(np.float32)
    before = trb.LAUNCHES
    with jt.config.bf16_mode(), torch.inference_mode():
        assert tmodel.uses_kernel(torch.zeros(1, dtype=torch.bfloat16))
        got = tmodel(x)
        got_plain = plain(x)
    assert got.dtype == torch.bfloat16
    assert trb.LAUNCHES == before  # CPU tensors run the twin, no launch
    for out in (got, got_plain):
        err = np.abs(out.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("path", ["f32_plain", "bf16_kernel"])
def test_int8_logits_match_jax_int8_mode(path):
    jmodel = jm.ResMLPForImageClassification(**SMALL)
    tmodel = jt.ResMLPForImageClassification(**SMALL, **CPU).eval()
    x = _x((4, 3, 32, 32), seed=2)
    with jconfig.int8_mode():
        want = np.asarray(jmodel(x))
    dtype = torch.float32
    if path == "bf16_kernel":
        tmodel.to_bf16()
        dtype = torch.bfloat16
    before = trq.LAUNCHES
    with jt.config.int8_mode(), torch.inference_mode():
        assert tmodel.uses_kernel(torch.zeros(1, dtype=dtype)) == (path == "bf16_kernel")
        got = tmodel.forward(torch.from_numpy(x).to(dtype)).float().numpy()
    assert trq.LAUNCHES == before
    err = np.abs(got - want).max()
    assert err <= 5e-2 * np.abs(want).max(), err
    with jt.config.parity_mode(), torch.inference_mode():
        exact = tmodel.float()(x).numpy()
    assert np.abs(exact - got).max() > 0  # the int8 path really ran


def test_final_affine_is_not_applied():
    m = jt.ResMLPForImageClassification(**SMALL, **CPU).eval()
    x = torch.from_numpy(_x((2, 3, 32, 32), seed=3))
    with torch.inference_mode():
        before = m(x)
        m.affine.alpha.fill_(3.0)
        m.affine.beta.fill_(-1.0)
        after = m(x)
    assert torch.equal(before, after)


def test_kernel_gate_and_options():
    m = jt.ResMLPForImageClassification(**SMALL, **CPU)
    bf = torch.zeros(1, dtype=torch.bfloat16)
    assert m.eval().uses_kernel(bf)
    assert not m.uses_kernel(bf.float())
    assert m.train().uses_kernel(bf)  # bf16 training runs the trainable kernels
    with jt.config.int8_mode():  # ... but not under int8, which a train step refuses
        assert m.eval().uses_kernel(bf) and not m.train().uses_kernel(bf)
    assert not jt.ResMLPForImageClassification(
        **SMALL, use_pallas=False, **CPU).eval().uses_kernel(bf)
    tp.check_block_runner(jt.ResMLPForImageClassification, SMALL, 32, stacks=1)
