"""Port's core/nnf.py against jittor_mlp_tpu.core.nnf on the CPU.

Inputs come from a seeded numpy generator and go to both sides. float32
agrees within 1e-5 (the JAX side under parity_mode); bf16 gelu and
layer_norm agree within one bf16 ulp of the JAX value (the two frameworks
round the same float32 value, but their float32 tanh/rsqrt may differ in the
last bit). In GELU's negative tail 1 + tanh(u) cancels in float32, so there
the bound is the float32 error of that sum, |x|·2⁻²³, where it is larger.
GroupNorm's bf16 backward and drop-path state their bands in their tests."""

import jax
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


def test_conv1x1_f32_and_int8():
    r = _rng()
    x = r.standard_normal((2, 5, 6, 16)).astype(np.float32)
    w = r.standard_normal((24, 16, 1, 1)).astype(np.float32)
    b = r.standard_normal((24,)).astype(np.float32)
    p = {"weight": _j(w), "bias": _j(b)}
    with jconfig.parity_mode():
        want = jnnf.conv1x1(p, _j(x))
    _f32_close(tnnf.conv1x1(_t(x), _t(w), _t(b)), want)
    with jconfig.int8_mode():
        want8 = jnnf.conv1x1(p, _j(x))
    from jittor_mlp_tpu_torch import config as tconfig

    with tconfig.int8_mode():
        got8 = tnnf.conv1x1(_t(x), _t(w), _t(b))
    _f32_close(got8, want8)
    assert np.abs(np.asarray(want8) - np.asarray(want)).max() > 1e-4  # int8 really ran


def _gn_inputs(C=24, seed=0):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((2, 5, 6, C)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.3 * r.standard_normal(C)).astype(np.float32)
    b = (0.3 * r.standard_normal(C)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("groups", [1, 3])
def test_group_norm_f32(groups):
    x, w, b = _gn_inputs()
    with jconfig.parity_mode():
        want = jnnf.group_norm({"weight": _j(w), "bias": _j(b)}, _j(x), groups)
        want_plain = jnnf.group_norm(None, _j(x), groups)
    _f32_close(tnnf.group_norm(_t(x), _t(w), _t(b), groups), want)
    _f32_close(tnnf.group_norm(_t(x), num_groups=groups), want_plain)


@pytest.mark.parametrize("groups", [1, 3])
def test_group_norm_bf16_forward_within_one_ulp(groups):
    x, w, b = _gn_inputs(seed=1)
    want = jnnf.group_norm({"weight": _j(w, jnp.bfloat16), "bias": _j(b, jnp.bfloat16)},
                           _j(x, jnp.bfloat16), groups)
    got = tnnf.group_norm(_t(x, torch.bfloat16), _t(w, torch.bfloat16), _t(b, torch.bfloat16),
                          groups)
    assert got.dtype == torch.bfloat16
    _assert_within_bf16_ulp(_np(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("groups", [1, 3])
def test_group_norm_bf16_backward(groups):
    """GroupNormAffine's analytic backward (bf16 x, w, b) against jax.vjp of
    nnf.group_norm in bf16 (the same analytic VJP): every gradient within
    two bf16 ulps of max|grad| (the two frameworks sum in other orders);
    and against autograd of the composed float32 form on the same bf16
    values: within 2e-2 global relative L2 (x̂ is rounded to bf16 before the
    affine, and the gradients to bf16 at the end)."""
    x, w, b = _gn_inputs(seed=2)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jb = [_j(a, jnp.bfloat16) for a in (x, w, b, dy)]
    _, vjp = jax.vjp(lambda x_, w_, b_: jnnf.group_norm({"weight": w_, "bias": b_}, x_, groups),
                     *jb[:3])
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jb[3])]
    leaves = [_t(a, torch.bfloat16).requires_grad_() for a in (x, w, b)]
    y = tnnf.group_norm(*leaves, num_groups=groups)
    got = torch.autograd.grad(y, leaves, _t(dy, torch.bfloat16))
    for name, g, wnt in zip(("dx", "dw", "db"), got, want):
        assert g.dtype == torch.bfloat16, name
        err = np.abs(_np(g) - wnt).max()
        assert err <= 2 * 2.0**-7 * np.abs(wnt).max(), (name, err)
    ref = [_t(a, torch.bfloat16).float().requires_grad_() for a in (x, w, b)]
    yf = tnnf.group_norm(*ref, num_groups=groups)
    ref_g = torch.autograd.grad(yf, ref, _t(dy, torch.bfloat16).float())
    num = sum(float(((_np(g) - _np(r)) ** 2).sum()) for g, r in zip(got, ref_g))
    den = sum(float((_np(r) ** 2).sum()) for r in ref_g)
    assert (num / den) ** 0.5 <= 2e-2


def test_drop_path_identity_cases():
    x = _t(_rng().standard_normal((8, 3, 3, 4)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    assert tnnf.drop_path(x, 0.5, False, g) is x  # eval
    assert tnnf.drop_path(x, 0.0, True, g) is x  # rate 0
    assert tnnf.drop_path(x, 0.5, True) is x  # no generator


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drop_path_keep_rate_and_scale(dtype):
    """20,000 samples at rate 0.3: the kept share lies within 5 binomial
    standard deviations (0.0162) of 0.7; kept samples are x / keep with keep
    in x's dtype (the JAX rounding point), dropped ones are 0; the same seed
    gives the same mask, another seed another."""
    n, rate = 20000, 0.3
    x = _t(np.random.default_rng(4).standard_normal((n, 2)).astype(np.float32), dtype)
    y = tnnf.drop_path(x, rate, True, torch.Generator().manual_seed(7))
    kept = (y != 0).all(1)
    assert abs(kept.float().mean().item() - 0.7) <= 5 * (0.7 * 0.3 / n) ** 0.5
    keep = torch.tensor(np.float32(1) - np.float32(rate), dtype=dtype)
    assert torch.equal(y[kept], x[kept] / keep)
    assert torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    again = tnnf.drop_path(x, rate, True, torch.Generator().manual_seed(7))
    other = tnnf.drop_path(x, rate, True, torch.Generator().manual_seed(8))
    assert torch.equal(y, again) and not torch.equal(y, other)
    mask = tnnf.drop_path_mask(n, rate, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(tnnf.drop_path(x, rate, True, mask=mask), y)


# (kernel, stride, padding, groups ("dw": depthwise), dilation)
CONV_CASES = [
    (1, 1, 0, 1, 1),  # the dense product
    (1, 1, "same", 1, 1),  # the dense product
    (1, 1, 0, "dw", 1),  # 1×1 depthwise: groups ≠ 1, so F.conv2d
    (3, 1, 1, 1, 1),
    (3, 2, 1, 1, 1),  # CycleMLP's and Hire-MLP's stride-2 transitions
    (7, 4, 2, 1, 1),  # CycleMLP's and ActiveMLP's stem
    (7, 4, 3, 1, 1),  # Hire-MLP's stem
    (5, 1, (2, 1), 1, 1),  # a pair
    (3, 1, ((1, 0), (2, 1)), 1, 1),  # a pair of pairs
    (5, 2, ((2, 2), (1, 2)), 1, 1),
    (3, 1, "same", "dw", 1),
    (7, 1, 3, "dw", 1),  # MS-MLP's widest depthwise conv
    (3, 1, 2, 1, 2),  # dilation 2
    (3, 1, "same", 1, 2),
    (3, 2, "same", 1, 1),  # XLA's "SAME" at stride 2
    (4, 1, "same", 1, 1),  # an even kernel: the extra pad after
]


def _conv_id(case):
    k, s, p, g, d = case
    return f"k{k}_s{s}_p{str(p).replace(' ', '')}_g{g}_d{d}"


@pytest.mark.parametrize("case", CONV_CASES, ids=[_conv_id(c) for c in CONV_CASES])
def test_conv2d_f32(case):
    """nnf.conv2d against JAX's on NHWC x and an OIHW weight, within 1e-5
    of max|ref|."""
    k, stride, padding, groups, dilation = case
    r = _rng()
    C = 6
    groups = C if groups == "dw" else groups
    O = C if groups == C else 10
    x = r.standard_normal((2, 13, 11, C)).astype(np.float32)
    w = r.standard_normal((O, C // groups, k, k)).astype(np.float32)
    b = r.standard_normal((O,)).astype(np.float32)
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dilation)
    with jconfig.parity_mode():
        want = np.asarray(jnnf.conv2d({"weight": _j(w), "bias": _j(b)}, _j(x), **kw))
    got = _np(tnnf.conv2d(_t(x), _t(w), _t(b), **kw))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_conv2d_int8_only_on_the_dense_path():
    """Under int8_mode() a 1×1 conv (groups 1, stride 1, padding 0) is
    JAX's int8 _dense; a 3×3 conv is never int8, in either package."""
    from jittor_mlp_tpu_torch import config as tconfig

    r = _rng()
    x = r.standard_normal((2, 5, 6, 16)).astype(np.float32)
    w1 = r.standard_normal((24, 16, 1, 1)).astype(np.float32)
    w3 = r.standard_normal((24, 16, 3, 3)).astype(np.float32)
    b = r.standard_normal((24,)).astype(np.float32)
    with jconfig.parity_mode():
        exact1 = np.asarray(jnnf.conv2d({"weight": _j(w1), "bias": _j(b)}, _j(x)))
    with jconfig.int8_mode():
        want1 = np.asarray(jnnf.conv2d({"weight": _j(w1), "bias": _j(b)}, _j(x)))
    with tconfig.int8_mode():
        got1 = tnnf.conv2d(_t(x), _t(w1), _t(b))
        got3 = tnnf.conv2d(_t(x), _t(w3), _t(b), padding=1)
    _f32_close(got1, want1)
    assert np.abs(want1 - exact1).max() > 1e-4  # int8 really ran
    with tconfig.parity_mode():
        assert torch.equal(got3, tnnf.conv2d(_t(x), _t(w3), _t(b), padding=1))


def test_conv2d_bf16_within_band():
    """bf16 x and weights: within two bf16 ulps of max|ref| of the JAX
    float32 conv on the same bf16 values (cuDNN or oneDNN against XLA, each
    rounding its sum once)."""
    r = _rng()
    x = r.standard_normal((2, 9, 9, 8)).astype(np.float32)
    w = r.standard_normal((8, 1, 3, 3)).astype(np.float32)
    b = r.standard_normal((8,)).astype(np.float32)
    xb, wb, bb = (_t(a, torch.bfloat16) for a in (x, w, b))
    with jconfig.parity_mode():
        want = np.asarray(jnnf.conv2d({"weight": _j(_np(wb)), "bias": _j(_np(bb))},
                                      _j(_np(xb)), padding=1, groups=8))
    got = tnnf.conv2d(xb, wb, bb, padding=1, groups=8)
    assert got.dtype == torch.bfloat16
    assert np.abs(_np(got) - want).max() <= 2 * 2.0**-7 * np.abs(want).max()


def test_relu_and_sigmoid_f32():
    x = _rng().standard_normal((3, 5, 17)).astype(np.float32) * 4
    _f32_close(tnnf.relu(_t(x)), jnnf.relu(_j(x)))
    _f32_close(tnnf.sigmoid(_t(x)), jnnf.sigmoid(_j(x)))


@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1), (5, 3, 2)])
def test_max_pool2d_f32(kernel, stride, padding):
    """NHWC max pool against JAX's reduce_window with -inf padding; an
    all-negative input shows that the padding never wins."""
    x = _rng().standard_normal((2, 11, 9, 5)).astype(np.float32) - 10.0
    want = np.asarray(jnnf.max_pool2d(_j(x), kernel, stride, padding))
    got = _np(tnnf.max_pool2d(_t(x), kernel, stride, padding))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _bn_params(r, C):
    return {"weight": r.standard_normal(C).astype(np.float32),
            "bias": r.standard_normal(C).astype(np.float32),
            "running_mean": r.standard_normal(C).astype(np.float32),
            "running_var": r.uniform(0.2, 3.0, C).astype(np.float32)}


def _t_bn(p, dtype=torch.float32):
    return [_t(p[k], dtype) for k in ("running_mean", "running_var", "weight", "bias")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_f32(train):
    r = _rng()
    x = (r.standard_normal((4, 6, 5, 7)) * 3 + 1).astype(np.float32)
    p = _bn_params(r, 7)
    with jconfig.parity_mode():
        want = jnnf.batch_norm({k: _j(v) for k, v in p.items()}, _j(x), train=train)
    _f32_close(tnnf.batch_norm(_t(x), *_t_bn(p), train=train), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_bf16_within_one_ulp(train):
    """bf16 x and parameters: statistics, scale and shift in float32, then
    x·scale + shift in bf16, as JAX; within one bf16 ulp of the JAX value
    (or of the result's scale, where the sum cancels)."""
    r = _rng()
    x = _np(_t((r.standard_normal((4, 6, 5, 7)) * 3 + 1).astype(np.float32), torch.bfloat16))
    p = {k: _np(_t(v, torch.bfloat16)) for k, v in _bn_params(r, 7).items()}
    want = jnnf.batch_norm({k: _j(v, jnp.bfloat16) for k, v in p.items()},
                           _j(x, jnp.bfloat16), train=train)
    got = tnnf.batch_norm(_t(x, torch.bfloat16), *_t_bn(p, torch.bfloat16), train=train)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    _assert_within_bf16_ulp(_np(got), want, atol=2.0**-8 * np.abs(want).max())


def test_batch_norm_train_reports_statistics_and_touches_no_buffer():
    """Train mode normalizes with the biased batch statistics (JAX's
    jnp.var); inside bn_stats() it reports (running_mean, mean, var, n),
    n the elements reduced per channel (JAX's sink's n); the running
    tensors are left as they were. ``axis`` picks the channel
    axis (RepMLPNet's grouped BatchNorms on NCHW partitions)."""
    r = _rng()
    x = _t(r.standard_normal((3, 4, 5, 6)).astype(np.float32))
    rm, rv, w, b = _t_bn(_bn_params(r, 6))
    rm0, rv0 = rm.clone(), rv.clone()
    with tnnf.bn_stats() as sink:
        y = tnnf.batch_norm(x, rm, rv, w, b, train=True)
    (site, mean, var, n), = sink
    assert site is rm and n == 3 * 4 * 5
    _f32_close(mean, x.mean((0, 1, 2)).numpy())
    _f32_close(var, x.var((0, 1, 2), correction=0).numpy())
    _f32_close(y, ((x - mean) / torch.sqrt(var + 1e-5) * w + b).numpy())
    assert torch.equal(rm, rm0) and torch.equal(rv, rv0)
    with tnnf.bn_stats() as sink:
        tnnf.batch_norm(x, rm, rv, w, b)  # eval: reports nothing
    assert sink == []
    xc = x.permute(0, 3, 1, 2)  # channels on axis 1
    _f32_close(tnnf.batch_norm(xc, rm, rv, w, b, train=True, axis=1).permute(0, 2, 3, 1), y)
