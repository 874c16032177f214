"""Port's core/nnf.py against jittor_mlp_tpu.core.nnf on the CPU.

Inputs come from a seeded numpy generator and go to both sides. float32
agrees within 1e-5 (the JAX side under parity_mode); bf16 gelu and
layer_norm agree within one bf16 ulp of the JAX value (the two frameworks
round the same float32 value, but their float32 tanh/rsqrt may differ in the
last bit). In GELU's negative tail 1 + tanh(u) cancels in float32, so there
the bound is the float32 error of that sum, |x|·2⁻²³, where it is larger."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.core import nnf as jnnf
from jittor_mlp_tpu_torch.core import nnf as tnnf


def _rng():
    return np.random.default_rng(0)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _assert_within_bf16_ulp(got, want, ulps=1, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    # one step crossing a power of two is one ulp of the larger binade
    mag = np.maximum(np.maximum(np.abs(want), np.abs(got)),
                     np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    excess = np.abs(got - want) - np.maximum(ulps * ulp, atol)
    assert excess.max() <= 0, f"off by more than {ulps} bf16 ulp: {excess.max():.3e}"


def _f32_close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_gelu_f32():
    x = _rng().standard_normal((4, 7, 33)).astype(np.float32) * 3
    with jconfig.parity_mode():
        want = jnnf.gelu(_j(x))
    _f32_close(tnnf.gelu(_t(x)), want)


def test_gelu_bf16_within_one_ulp():
    x = _rng().standard_normal((4, 7, 33)).astype(np.float32) * 3
    want = np.asarray(jnnf.gelu(_j(x, jnp.bfloat16)).astype(jnp.float32))
    got = tnnf.gelu(_t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    xb = _np(_t(x, torch.bfloat16))
    _assert_within_bf16_ulp(_np(got), want, atol=np.abs(xb) * 2.0**-23)


def test_linear_f32():
    r = _rng()
    x = r.standard_normal((3, 5, 16)).astype(np.float32)
    w = r.standard_normal((24, 16)).astype(np.float32)
    b = r.standard_normal((24,)).astype(np.float32)
    with jconfig.parity_mode():
        want = jnnf.linear({"weight": _j(w), "bias": _j(b)}, _j(x))
    _f32_close(tnnf.linear(_t(x), _t(w), _t(b)), want)


def test_conv1d_token_f32():
    r = _rng()
    x = r.standard_normal((3, 10, 16)).astype(np.float32)
    w = r.standard_normal((12, 10, 1)).astype(np.float32)
    b = r.standard_normal((12,)).astype(np.float32)
    with jconfig.parity_mode():
        want = jnnf.conv1d_token({"weight": _j(w), "bias": _j(b)}, _j(x))
    _f32_close(tnnf.conv1d_token(_t(x), _t(w), _t(b)), want)


@pytest.mark.parametrize("hw,patch", [((16, 16), 4), ((8, 16), (4, 4))])
def test_patch_embed_f32(hw, patch):
    r = _rng()
    x = r.standard_normal((2, *hw, 3)).astype(np.float32)
    w = r.standard_normal((8, 3, 4, 4)).astype(np.float32)
    b = r.standard_normal((8,)).astype(np.float32)
    with jconfig.parity_mode():
        want = jnnf.patch_embed({"weight": _j(w), "bias": _j(b)}, _j(x), patch)
    _f32_close(tnnf.patch_embed(_t(x), _t(w), _t(b), patch), want)


def test_layer_norm_f32():
    r = _rng()
    x = r.standard_normal((3, 5, 40)).astype(np.float32) * 2 + 1
    w = r.standard_normal((40,)).astype(np.float32)
    b = r.standard_normal((40,)).astype(np.float32)
    with jconfig.parity_mode():
        want = jnnf.layer_norm({"weight": _j(w), "bias": _j(b)}, _j(x))
    _f32_close(tnnf.layer_norm(_t(x), _t(w), _t(b)), want)


def test_layer_norm_bf16_within_one_ulp():
    r = _rng()
    x = r.standard_normal((3, 5, 40)).astype(np.float32) * 2 + 1
    w = r.standard_normal((40,)).astype(np.float32)
    b = r.standard_normal((40,)).astype(np.float32)
    want = jnnf.layer_norm({"weight": _j(w, jnp.bfloat16), "bias": _j(b, jnp.bfloat16)},
                           _j(x, jnp.bfloat16))
    got = tnnf.layer_norm(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                          _t(b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_within_bf16_ulp(_np(got), np.asarray(want.astype(jnp.float32)))


def test_global_avg_pool_tokens_f32():
    x = _rng().standard_normal((3, 9, 16)).astype(np.float32)
    with jconfig.parity_mode():
        want = jnnf.global_avg_pool_tokens(_j(x))
    _f32_close(tnnf.global_avg_pool_tokens(_t(x)), want)
