"""The port's deformable convolution and ops/dcn.py against
jittor_mlp_tpu.ops.deform / ops.dcn, on the CPU.

Inputs come from a seeded numpy generator and go to both sides; the JAX
side runs under parity_mode() in float32. The cases are those of the JAX
``tests/test_dcn.py`` that need no reference:

- ``deform_conv2d`` (NHWC) against JAX ``deform_conv2d`` within 1e-5 of
  max|ref|: strides 1 and 2, dilation 2, two offset groups, a modulation
  mask, two weight groups, offsets that leave the map, with and without
  bias; zero offsets equal ``nnf.conv2d`` (strides and dilations 1 and
  2), NHWC and through the NCHW ``dcn_v2_conv``; the ``deform_conv2d_jt``
  shim.
- ``dcn_v2_pooling`` against JAX (out and top_count) with and without
  trans, group_size 1 and 2, RoIs partly and wholly off the map; a
  constant map pools to the constant.
- The modules on the JAX objects' weights (``from_jax``): DeformConv,
  DCNv2, DCN (random ``conv_offset_mask``, two offset groups), DCNPooling
  (random ``offset_mask_fc``) and DCNv2Pooling; the same seed gives the
  same weights; a reference state dict loads by name.
- bf16: the sampling positions stay float32. At H = W = 72 a bf16
  position moves in steps of 0.25 past row 64; a 1×1 identity deformable
  conv in bf16 equals the float32-position sample on the same bf16 values
  within one bf16 ulp, and the same check fails when ``sample_positions``
  is swapped for one that rounds the positions in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.ops import dcn as jdcn
from jittor_mlp_tpu.ops import deform as jdeform
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.ops import dcn as tdcn
from jittor_mlp_tpu_torch.ops import deform as tdeform

CPU = dict(device="cpu")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _within(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{err:.3e} > {tol} of {np.abs(want).max():.3e}"


# (B, H, W, Cin, Cout, k, stride, padding, dilation, offset groups, weight groups, mask, bias,
#  offset scale)
CONV_CASES = {
    "s1_g2_mask": (2, 9, 10, 8, 12, 3, 1, 1, 1, 2, 1, True, True, 1.5),
    "s2": (2, 11, 9, 4, 6, 3, 2, 1, 1, 1, 1, False, True, 1.5),
    "dilation2": (1, 12, 12, 4, 5, 3, 1, 2, 2, 1, 1, True, False, 1.5),
    "weight_groups2": (2, 8, 8, 8, 6, 3, 1, 1, 1, 2, 2, True, True, 1.5),
    "off_map": (2, 6, 7, 4, 4, 3, 1, 0, 1, 1, 1, True, True, 6.0),
    "k1x2_s2_g4": (1, 10, 10, 8, 8, (1, 2), (2, 1), (0, 1), 1, 4, 1, False, False, 2.0),
}


def _conv_inputs(case, seed=0):
    B, H, W, C, O, k, stride, pad, dil, G, wg, mask, bias, scale = CONV_CASES[case]
    kh, kw = (k, k) if isinstance(k, int) else k
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    Ho = (H + 2 * ph - dil * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dil * (kw - 1) - 1) // sw + 1
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, H, W, C)).astype(np.float32)
    off = (r.standard_normal((B, Ho, Wo, 2 * G * kh * kw)) * scale).astype(np.float32)
    m = r.uniform(0, 1, (B, Ho, Wo, G * kh * kw)).astype(np.float32) if mask else None
    w = (r.standard_normal((O, C // wg, kh, kw)) * 0.2).astype(np.float32)
    b = r.standard_normal(O).astype(np.float32) if bias else None
    return x, off, m, w, b, dict(stride=stride, padding=pad, dilation=dil)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_deform_conv2d_matches_jax(case):
    x, off, m, w, b, kw = _conv_inputs(case)
    jn = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    with jconfig.parity_mode():
        want = np.asarray(jdeform.deform_conv2d(jn(x), jn(off), jn(w), jn(b), mask=jn(m), **kw))
    with config.parity_mode():
        got = tdeform.deform_conv2d(_t(x), _t(off), _t(w), None if b is None else _t(b),
                                    mask=None if m is None else _t(m), **kw)
    _within(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 2)])
def test_zero_offsets_equal_conv2d(stride, dilation):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 9, 8, 4)).astype(np.float32)
    w = (r.standard_normal((6, 4, 3, 3)) * 0.2).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    Ho = (9 + 2 - 2 * dilation - 1) // stride + 1
    Wo = (8 + 2 - 2 * dilation - 1) // stride + 1
    with config.parity_mode():
        got = tdeform.deform_conv2d(_t(x), torch.zeros(2, Ho, Wo, 18), _t(w), _t(b),
                                    stride=stride, padding=1, dilation=dilation)
        want = nnf.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=1, dilation=dilation)
    _within(got.numpy(), want.numpy(), 1e-6)
    nchw = tdcn.dcn_v2_conv(_t(x).permute(0, 3, 1, 2), torch.zeros(2, 18, Ho, Wo), None, _t(w),
                            _t(b), stride=stride, padding=1, dilation=dilation)
    _within(nchw.permute(0, 2, 3, 1).numpy(), want.numpy(), 1e-6)


def test_deform_conv2d_jt_shim():
    out = tdcn.deform_conv2d_jt(torch.ones(1, 4, 6, 6), torch.zeros(1, 2, 6, 6),
                                torch.full((4, 4, 1, 1), 0.25))
    assert out.shape == (1, 4, 6, 6) and torch.allclose(out, torch.ones(1, 4, 6, 6))


def _rois():
    return np.array([[0, 1, 1, 10, 10], [1, 4, 4, 12, 12], [0, -6, 3, 5, 30],
                     [1, 14, 14, 40, 40], [0, 0, 0, 0, 0]], np.float32)


@pytest.mark.parametrize("group_size", [1, 2])
@pytest.mark.parametrize("no_trans", [True, False], ids=["no_trans", "trans"])
def test_dcn_v2_pooling_matches_jax(no_trans, group_size):
    r = np.random.default_rng(3)
    P, O = 3, 4
    C = O * group_size * group_size
    x = r.standard_normal((2, C, 16, 16)).astype(np.float32)
    trans = (r.standard_normal((5, 4, P, P))).astype(np.float32)  # two classes
    args = (1.0, P, O, no_trans, group_size, P, 4, 0.3)
    with jconfig.parity_mode():
        want, wcnt = jdcn.dcn_v2_pooling(jnp.asarray(x), jnp.asarray(_rois()),
                                         jnp.asarray(trans), *args)
    got, cnt = tdcn.dcn_v2_pooling(_t(x), _t(_rois()), _t(trans), *args)
    _within(got.numpy(), np.asarray(want), 1e-5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    assert (cnt.numpy() == 0).any() and (cnt.numpy() == 16).any()  # off the map, wholly in


def test_psroi_pooling_uniform_average():
    pool = tdcn.DCNv2Pooling(spatial_scale=1.0, pooled_size=2, output_dim=8, no_trans=True,
                             group_size=2, **CPU)
    out = pool(torch.full((1, 32, 16, 16), 3.0), torch.tensor([[0, 0, 0, 7, 7.0]]))
    assert out.shape == (1, 8, 2, 2)
    torch.testing.assert_close(out, torch.full_like(out, 3.0), rtol=1e-5, atol=0)


def _randomize_conv_offset_mask(jm, seed):
    r = np.random.default_rng(seed)
    w = jm.conv_offset_mask["weight"]
    jm.conv_offset_mask = {"weight": jnp.asarray(r.standard_normal(w.shape) * 0.3, jnp.float32),
                           "bias": jnp.asarray(r.standard_normal(w.shape[0]) * 2.0, jnp.float32)}
    jm.bias = jnp.asarray(r.standard_normal(jm.bias.shape), jnp.float32)


@pytest.mark.parametrize("groups", [1, 2])
def test_dcn_module_matches_jax(groups):
    jm = jdcn.DCN(4, 6, 3, 1, 1, deformable_groups=groups, seed=2)
    _randomize_conv_offset_mask(jm, groups)
    tm = tdcn.DCN(4, 6, 3, 1, 1, deformable_groups=groups, seed=7, **CPU).from_jax(jm)
    x = np.random.default_rng(3).standard_normal((2, 4, 12, 12)).astype(np.float32)
    with jconfig.parity_mode():
        want = np.asarray(jm(jnp.asarray(x)))
    with config.parity_mode(), torch.no_grad():
        got = tm(_t(x))
    _within(got.numpy(), want, 1e-5)
    assert sorted(tm.state_dict()) == ["bias", "conv_offset_mask.bias",
                                      "conv_offset_mask.weight", "weight"]


def test_deform_conv_and_dcnv2_match_jax():
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 4, 9, 9)).astype(np.float32)
    off = (r.standard_normal((2, 18, 5, 5)) * 2).astype(np.float32)
    mask = r.uniform(0, 1, (2, 9, 5, 5)).astype(np.float32)
    for jcls, tcls, extra in ((jdcn.DeformConv, tdcn.DeformConv, ()),
                              (jdcn.DCNv2, tdcn.DCNv2, (mask,))):
        jm = jcls(4, 6, 3, 2, 1, seed=5)
        tm = tcls(4, 6, 3, 2, 1, seed=5, **CPU)
        np.testing.assert_array_equal(tm.weight.detach().numpy(), np.asarray(jm.weight))
        with jconfig.parity_mode():
            want = np.asarray(jm(jnp.asarray(x), jnp.asarray(off),
                                 *(jnp.asarray(a) for a in extra)))
        with torch.no_grad():
            got = tm(_t(x), _t(off), *(_t(a) for a in extra))
        _within(got.numpy(), want, 1e-5)


def test_deform_conv_loads_reference_state_dict_without_bias():
    tm = tdcn.DeformConv(4, 6, 3, **CPU)
    w = torch.randn(6, 4, 3, 3)
    tm.load_torch_state_dict({"weight": w})
    assert torch.equal(tm.weight.detach(), w) and not tm.bias.any()
    with pytest.raises(KeyError, match="unexpected"):
        tm.load_torch_state_dict({"weight": w, "scale": w})
    with pytest.raises(KeyError, match="missing"):
        tdcn.DCN(4, 6, 3, 1, 1, **CPU).load_torch_state_dict({"weight": w})


def test_dcn_pooling_matches_jax():
    P, C = 2, 8
    jp = jdcn.DCNPooling(spatial_scale=0.5, pooled_size=P, output_dim=C, no_trans=False,
                         group_size=2, trans_std=0.1, deform_fc_dim=16, seed=3)
    r = np.random.default_rng(6)
    last = jp.offset_mask_fc[2]
    jp.offset_mask_fc[2] = {"weight": jnp.asarray(r.standard_normal(last["weight"].shape),
                                                  jnp.float32),
                            "bias": jnp.asarray(r.standard_normal(last["bias"].shape),
                                                jnp.float32)}
    tp_ = tdcn.DCNPooling(spatial_scale=0.5, pooled_size=P, output_dim=C, no_trans=False,
                          group_size=2, trans_std=0.1, deform_fc_dim=16, seed=3, **CPU)
    np.testing.assert_array_equal(tp_.offset_mask_fc[2].weight.detach().numpy(),
                                  np.asarray(jp.offset_mask_fc[1]["weight"]))
    assert not tp_.offset_mask_fc[4].weight.any()
    tp_.from_jax(jp)
    x = r.standard_normal((2, 4 * C, 16, 16)).astype(np.float32)
    rois = _rois() * [1, 2, 2, 2, 2]  # at spatial_scale 0.5
    with jconfig.parity_mode():
        want = np.asarray(jp(jnp.asarray(x), jnp.asarray(rois)))
    with config.parity_mode(), torch.no_grad():
        got = tp_(_t(x), _t(rois))
    _within(got.numpy(), want, 1e-5)
    assert [k.split(".")[1] for k in tp_.state_dict()][::2] == ["0", "2", "4"]


def test_dcn_pooling_no_trans_matches_jax_pooling():
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 16)).astype(np.float32)
    jp = jdcn.DCNPooling(1.0, 2, 4, True, group_size=2)
    tp_ = tdcn.DCNPooling(1.0, 2, 4, True, group_size=2, **CPU)
    assert not list(tp_.state_dict())
    with jconfig.parity_mode():
        want = np.asarray(jp(jnp.asarray(x), jnp.asarray(_rois())))
    _within(tp_(_t(x), _t(_rois())).numpy(), want, 1e-5)


def test_modules_build_on_the_card_by_default():
    if torch.cuda.is_available():
        assert tdcn.DCN(4, 4, 3, 1, 1).weight.is_cuda
    else:
        for build in (lambda: tdcn.DCN(4, 4, 3, 1, 1), lambda: tdcn.DCNPooling(1.0, 2, 4, False)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
    assert tdcn.HEADS.get("DCN") is tdcn.DCN


def _bf16_identity_sample_ok():
    """A 1×1 deformable conv with an identity weight in bf16 at 72 × 72
    against the float32-position sample of the same bf16 values: every
    output within one bf16 ulp."""
    r = np.random.default_rng(5)
    C = 4
    xb = _t(r.standard_normal((1, 72, 72, C)), torch.bfloat16)
    offb = _t(r.uniform(-2, 2, (1, 72, 72, 2)), torch.bfloat16)
    eye = torch.eye(C).reshape(C, C, 1, 1)
    got = tdeform.deform_conv2d(xb, offb, eye.bfloat16())
    assert got.dtype == torch.bfloat16
    with jconfig.parity_mode():
        want = np.asarray(jdeform.deform_conv2d(
            jnp.asarray(xb.float().numpy()), jnp.asarray(offb.float().numpy()),
            jnp.asarray(eye.numpy())))
    want_b = _t(want, torch.bfloat16).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return (np.abs(got.float().numpy() - want_b) <= ulp).all()


def test_bf16_sampling_positions_stay_float32(monkeypatch):
    off = _t(np.random.default_rng(5).uniform(-2, 2, (72, 72)), torch.bfloat16)
    rows = torch.arange(72).reshape(72, 1)
    pos_bf16 = (rows.to(torch.bfloat16) + off).float()
    assert (pos_bf16 != rows + off.float()).float().mean() > 0.1  # bf16 positions round off
    assert _bf16_identity_sample_ok()
    # the mutant: positions rounded in the offsets' dtype, as the JAX function builds them
    monkeypatch.setattr(tdeform, "sample_positions",
                        lambda base, off: (base.to(off.dtype) + off).float())
    assert not _bf16_identity_sample_ok()
