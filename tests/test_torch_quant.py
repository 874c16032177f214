"""The port's quant.py and int8 nnf routing against jittor_mlp_tpu's, on the CPU.

Inputs come from a seeded numpy generator and go to both sides.
``dynamic_int8_matmul`` agrees within 1e-6 (its integer product is exact on
both sides, float32 for K ≤ 1040 and float64 above); the activation and
weight quantizers of the W8A8 kernels give the same codes and scales; the
weight-only int8 state dict dequantizes to exactly what the JAX package's
``dequantize_tree(quantize_tree(params))`` gives, including its rule on
depth-stacked leaves (a stacked bias or LayerNorm weight gets one scale
per layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu import quant as jquant
from jittor_mlp_tpu.core import nnf as jnnf
from jittor_mlp_tpu.ops.pallas import mixer_block_int8 as jq
from jittor_mlp_tpu_torch import quant as tquant
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.core import nnf as tnnf


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("k", [33, 1500], ids=["f32_exact", "f64_exact"])
def test_dynamic_int8_matmul_matches_jax(k):
    r = _rng()
    x = r.standard_normal((5, 7, k)).astype(np.float32)
    wt = r.standard_normal((k, 11)).astype(np.float32)
    want = np.asarray(jquant.dynamic_int8_matmul(jnp.asarray(x), jnp.asarray(wt)))
    got = tquant.dynamic_int8_matmul(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.dtype == torch.float32 and got.shape == (5, 7, 11)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_dynamic_int8_matmul_zero_rows():
    x = _rng(1).standard_normal((4, 16)).astype(np.float32)
    x[1] = 0.0
    wt = np.zeros((16, 8), np.float32)
    wt[:, :3] = _rng(2).standard_normal((16, 3))
    got = tquant.dynamic_int8_matmul(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    want = np.asarray(jquant.dynamic_int8_matmul(jnp.asarray(x), jnp.asarray(wt)))
    assert np.isfinite(got).all()
    assert (got[1] == 0).all() and (got[:, 3:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    zeros = tquant.dynamic_int8_matmul(torch.zeros(3, 16), torch.zeros(16, 8))
    assert torch.equal(zeros, torch.zeros(3, 8))


def test_kernel_quantizers_match_jax():
    """quant_act / quant_weight are the W8A8 kernels' _quant_act / _quant_w:
    the same codes and the same scales, bit for bit."""
    r = _rng(3)
    x = r.standard_normal((24, 40)).astype(np.float32) * 3
    x[:, 5] = 0.0  # an all-zero column: scale 1e-30/127, codes 0
    for axis in (0, 1):
        qj, sj = jq._quant_act(jnp.asarray(x), axis)
        qt, st = tquant.quant_act(torch.from_numpy(x), axis)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj, np.float32))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    w = r.standard_normal((12, 40)).astype(np.float32)
    w[3] = 0.0
    qj, sj = jq._quant_w(jnp.asarray(w, jnp.bfloat16), 1)
    qt, st = tquant.quant_weight(torch.from_numpy(w).bfloat16(), 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj, np.float32))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _nnf_cases():
    r = _rng(4)
    x3 = r.standard_normal((3, 10, 16)).astype(np.float32)
    return {
        "linear": (
            lambda j, x, w, b: jnnf.linear({"weight": j(w), "bias": j(b)}, j(x)),
            lambda t, x, w, b: tnnf.linear(t(x), t(w), t(b)),
            (x3, r.standard_normal((24, 16)), r.standard_normal(24))),
        "conv1d_token": (
            lambda j, x, w, b: jnnf.conv1d_token({"weight": j(w), "bias": j(b)}, j(x)),
            lambda t, x, w, b: tnnf.conv1d_token(t(x), t(w), t(b)),
            (x3, r.standard_normal((12, 10, 1)), r.standard_normal(12))),
        "patch_embed": (
            lambda j, x, w, b: jnnf.patch_embed({"weight": j(w), "bias": j(b)}, j(x), 4),
            lambda t, x, w, b: tnnf.patch_embed(t(x), t(w), t(b), 4),
            (r.standard_normal((2, 16, 16, 3)), r.standard_normal((8, 3, 4, 4)),
             r.standard_normal(8))),
    }


@pytest.mark.parametrize("op", ["linear", "conv1d_token", "patch_embed"])
def test_nnf_dense_ops_under_int8_mode_match_jax(op):
    jfn, tfn, args = _nnf_cases()[op]
    args = [np.asarray(a, np.float32) for a in args]
    with jconfig.int8_mode():
        want = np.asarray(jfn(jnp.asarray, *args))
    with jt.config.int8_mode():
        got = tfn(torch.from_numpy, *args)
    exact = tfn(torch.from_numpy, *args)  # outside the context: plain f32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(exact.numpy(), got.numpy(), rtol=0, atol=1e-7)


def test_int8_mode_is_per_thread():
    import threading

    seen = {}
    with jt.config.int8_mode():
        t = threading.Thread(target=lambda: seen.update(other=jt.config.int8_enabled()))
        t.start()
        t.join()
        seen["this"] = jt.config.int8_enabled()
    assert seen == {"this": True, "other": False}
    assert not jt.config.int8_enabled()


def test_affine_matches_jax():
    r = _rng(5)
    x = r.standard_normal((2, 9, 16)).astype(np.float32)
    a = r.standard_normal((1, 1, 16)).astype(np.float32)
    b = r.standard_normal((1, 1, 16)).astype(np.float32)
    want = np.asarray(jnnf.affine({"alpha": jnp.asarray(a), "beta": jnp.asarray(b)},
                                  jnp.asarray(x)))
    got = tnnf.affine(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# sizes where the JAX rule quantizes stacked biases, LayerNorm weights,
# affines and LayerScale gammas (≥ 2048 elements once stacked over depth)
MIXER = dict(d_model=192, depth=12, patch_size=8, image_size=32, num_classes=10)
RESMLP = dict(d_model=96, depth=24, patch_size=8, image_size=32, num_classes=10)
GMLP = dict(d_model=96, d_ffn=96, depth=24, patch_size=8, image_size=32, num_classes=10)
# per model: (a stacked bias, a token-mix weight)
_PROBE_KEYS = {
    "mlp_mixer": ("model.1.1.fn.net.0.bias", "model.1.0.fn.net.0.weight"),
    "res_mlp": ("model.1.ff.net.0.bias", "model.1.token_mix.weight"),
    "g_mlp": ("model.1.channel_proj1.bias", "model.1.sgu.spatial_proj.weight"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,factory,kw", [
    ("mlp_mixer", "MLPMixerForImageClassification", MIXER),
    ("res_mlp", "ResMLPForImageClassification", RESMLP),
    ("g_mlp", "gMLPForImageClassification", GMLP),
])
def test_int8_state_dict_equals_jax_dequantize_tree(name, factory, kw, dtype):
    jmodel = getattr(jm, factory)(**kw)
    tmodel = getattr(jt, factory)(**kw, device="cpu")
    jdq = jquant.dequantize_tree(
        jquant.quantize_tree(jax.tree.map(np.asarray, jmodel.params)), getattr(jnp, dtype))
    want = state_dict_from_jax(name, jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jdq))
    q = tquant.quantize_state_dict(name, tmodel.state_dict())
    got = tquant.dequantize_state_dict(q, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == getattr(torch, dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), want[k].numpy(), err_msg=k)
    # the stacked-leaf rule: per-layer scalar scales for stacked biases and
    # LayerNorm / affine weights; per-(layer, out) for token-mix weights
    stacked_bias, token_w = _PROBE_KEYS[name]
    assert isinstance(q[stacked_bias], dict) and q[stacked_bias]["scale"].numel() == 1
    assert q[token_w]["scale"].shape == (q[token_w]["q"].shape[0], 1, 1)
    assert not isinstance(q["mlp_head.0.bias"], dict)  # 1-D: passes through
