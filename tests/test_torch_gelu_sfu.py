"""The kernels' shared GELU, x·σ(2u) on the special-function unit, without a card.

``csrc/common.cuh``'s ``gelu_tanh`` evaluates the tanh form of GELU,
0.5·x·(1 + tanh u), as x / (1 + 2^a), a = −2·log2(e)·u, with one
``ex2.approx`` and one ``rcp.approx``; every forward GELU epilogue of the
port's CUDA kernels (bf16 and W8A8) and the Mixer backward's recomputes of
the forward's activations call it, and none calls libm's ``tanhf``. Here:
the sources hold no other forward tanh; the device arithmetic, emulated in
f32 with each intrinsic at the edges of its documented error, stays within
the bound the header states (which chip_smoke.py's sweep holds the card
to) over every finite bf16 in [-20, 20] and an f32 grid, and follows the
tanh form at its special values; and the port's plain gMLP, ResMLP and
Mixer blocks in bf16, with their GELU evaluated that way and moved by the
bound either way, stay within today's 1.6e-2 band of the JAX Pallas
kernels run in interpret mode. The plain twins themselves keep
``torch.tanh``.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke as cs
import jittor_mlp_tpu.ops.pallas.gmlp_block as jg
import jittor_mlp_tpu.ops.pallas.mixer_block as jmb
import jittor_mlp_tpu.ops.pallas.resmlp_block as jr
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.ops.kernels import _build
from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90 as g
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block as tg
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block as tr

CSRC = _build._CSRC
SQRT_2_PI, LOG2E = 0.7978845608028654, 1.4426950408889634


def _code(name):
    """A source without its // comments."""
    with open(os.path.join(CSRC, name)) as f:
        return re.sub(r"//[^\n]*", "", f.read())


def _header():
    with open(os.path.join(CSRC, "common.cuh")) as f:
        return f.read()


def test_no_forward_gelu_calls_libm_tanh():
    # the one tanhf left is the backward's derivative, gelu_tanh_grad
    sources = sorted(n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh")))
    found = {n: _code(n).count("tanhf(") for n in sources}
    assert {n: c for n, c in found.items() if c} == {"mixer_block_bwd.cu": 1}
    grad = _code("mixer_block_bwd.cu").split("float gelu_tanh_grad(float x) {", 1)[1]
    assert "tanhf(" in grad.split("\n}\n", 1)[0]
    body = _code("common.cuh").split("float gelu_tanh(float x) {", 1)[1].split("\n}\n", 1)[0]
    assert "ex2.approx.ftz.f32" in body and "rcp.approx.ftz.f32" in body and "tanh" not in body
    # every forward GELU epilogue takes it: the bf16 core's, the s8 core's, the lab's
    assert _code("gemm_bf16.cuh").count("gelu_tanh(v[e] + (per_row ? brow :") == 2
    assert _code("gemm_s8.cuh").count("gelu_tanh(__fadd_rn(v[e]") == 2
    assert "return gelu_tanh(z);" in _code("lab_block.cuh")


def _constants():
    consts = dict(re.findall(r"constexpr float (GELU_C\d) = (-?[\d.]+)f;", _header()))
    return float(consts["GELU_C1"]), float(consts["GELU_C3"])


def test_the_constants_are_the_tanh_forms():
    c1, c3 = _constants()
    assert c1 == pytest.approx(-2 * LOG2E * SQRT_2_PI, rel=1e-15)
    assert c3 == pytest.approx(c1 * 0.044715, rel=1e-15)


def _device(x, de=0.0, dr=0.0):
    """The kernel's gelu_tanh in f32, each step rounded as the card rounds
    it: a = x·fma(x², C3, C1); e = ex2.approx.ftz(a); r = rcp.approx.ftz(1 +
    e); x·r. ``de`` and ``dr`` move the two intrinsics' results by that
    relative error (their documented bounds: 2 ulps and 1 ulp)."""
    c1, c3 = (np.float32(c) for c in _constants())
    x = np.asarray(x, np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        x2 = x * x
        f = (x2.astype(np.float64) * np.float64(c3) + np.float64(c1)).astype(np.float32)
        a = x * f
        e = (np.exp2(a.astype(np.float64)) * (1 + de)).astype(np.float32)
        e = np.where(np.abs(e) < np.float32(2.0 ** -126), np.float32(0), e)  # .ftz
        s = np.float32(1) + e
        r = (1.0 / s.astype(np.float64) * (1 + dr)).astype(np.float32)
        r = np.where(np.abs(r) < np.float32(2.0 ** -126), np.float32(0), r)  # .ftz
        return x * r


def _f64(x):
    """chip_smoke's reference: the tanh form in float64 through x·σ(2u)."""
    return cs.gelu_f64(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _sweep():
    codes = np.arange(1 << 16, dtype=np.uint32) << 16
    xb = codes.view(np.float32)
    xb = xb[np.isfinite(xb) & (np.abs(xb) <= 20)]
    tails = np.geomspace(1e-30, 20, 1 << 15)
    grid = np.concatenate([np.linspace(-20, 20, 1 << 18), tails, -tails,
                           np.linspace(-10.01, -9.99, 4097)]).astype(np.float32)
    return np.concatenate([xb, grid])


@pytest.mark.parametrize("de", [-2.0 ** -22, 0.0, 2.0 ** -22])
@pytest.mark.parametrize("dr", [-2.0 ** -23, 2.0 ** -23])
def test_device_arithmetic_stays_within_the_headers_bound(de, dr):
    x = _sweep()
    got, ref = _device(x, de, dr).astype(np.float64), _f64(x)
    rel_zone = x >= -10.0
    err = np.abs(got - ref)
    nz = rel_zone & (ref != 0)
    assert (got[rel_zone & (ref == 0)] == 0).all()
    assert (err[nz] / np.abs(ref[nz])).max() <= cs.GELU_REL_BOUND
    assert err[~rel_zone].max() <= cs.GELU_ABS_BOUND
    # the header states the bounds chip_smoke.py holds the card to
    text = " ".join(_header().split())
    assert f"≤ {cs.GELU_REL_BOUND:.1e}".replace("e-05", "e-5") in text
    assert f"below {cs.GELU_ABS_BOUND:.1e}" in text


def test_device_arithmetic_follows_the_tanh_form_at_special_values():
    x = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e20, -1e20, 3e38, -3e38], np.float32)
    got = _device(x)
    assert got[0] == np.inf and np.isnan(got[1]) and np.isnan(got[2])
    assert got[3] == 0 and not np.signbit(got[3]) and got[4] == 0 and np.signbit(got[4])
    assert got[5] == x[5] and got[7] == x[7]
    assert all(got[i] == 0 and np.signbit(got[i]) for i in (6, 8))


def test_the_reference_is_the_tanh_form_where_float64_does_not_cancel():
    x = np.linspace(-3, 20, 10001).astype(np.float32)
    xd = x.astype(np.float64)
    tanh_form = 0.5 * xd * (1 + np.tanh(SQRT_2_PI * (xd + 0.044715 * xd ** 3)))
    np.testing.assert_allclose(_f64(x), tanh_form, rtol=1e-12, atol=1e-300)


# The plain blocks in bf16 with the kernels' GELU, against the JAX kernels.
def _sfu_gelu(sign):
    """x·σ(2u) in f32, moved by the header's bound: ``sign`` times it on
    alternate elements, the opposite on the others."""
    def gelu(x):
        xf = x.float()
        u = SQRT_2_PI * (xf + 0.044715 * xf * xf * xf)
        out = xf * torch.sigmoid(2.0 * u)
        flip = torch.ones(out.numel())
        flip[1::2] = -1
        return out * (1 + sign * cs.GELU_REL_BOUND * flip.reshape(out.shape))
    return gelu


def _rng_inputs(kind, seed=0):
    r = np.random.default_rng(seed)

    def v(n, scale, mean=0.0):
        return (mean + scale * r.standard_normal(n)).astype(np.float32)

    def lin(out, fan_in, bias_mean=0.0):
        return ((r.standard_normal((out, fan_in)) / np.sqrt(fan_in)).astype(np.float32),
                v(out, 0.5, bias_mean))

    if kind == "gmlp":
        B, N, D, F = 2, 20, 32, 48
        x = r.standard_normal((B, N, D)).astype(np.float32)
        return x, (v(D, 0.1, 1.0), v(D, 0.1), *lin(2 * F, D), v(F, 0.1, 1.0), v(F, 0.1),
                   *lin(N, N, bias_mean=1.0), *lin(D, F))
    if kind == "resmlp":
        B, N, D, F = 2, 20, 32, 96
        x = r.standard_normal((B, N, D)).astype(np.float32)
        return x, (v(D, 0.1, 1.0), v(D, 0.5), v(D, 0.1, 1.0), *lin(N, N), v(D, 0.1, 1.0),
                   v(D, 0.5), v(D, 0.1, 1.0), *lin(F, D), *lin(D, F))
    B, N, D, TD, CD = 2, 20, 32, 24, 64
    x = r.standard_normal((B, N, D)).astype(np.float32)
    return x, (v(D, 0.1, 1.0), v(D, 0.1), *lin(TD, N), *lin(N, TD), v(D, 0.1, 1.0), v(D, 0.1),
               *lin(CD, D), *lin(D, CD))


BLOCKS = {"gmlp": (jg.fused_gmlp_block, tg, "gmlp_block_ref"),
          "resmlp": (jr.fused_resmlp_block, tr, "resmlp_block_ref"),
          "mixer": (jmb.fused_mixer_block, tmb, "mixer_block_ref")}


@functools.lru_cache(maxsize=None)
def _jax_bf16(kind):
    x, weights = _rng_inputs(kind)
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        with jconfig.parity_mode():
            out = BLOCKS[kind][0](jnp.asarray(x, jnp.bfloat16),
                                  *(jnp.asarray(w, jnp.bfloat16) for w in weights), bt=2)
    finally:
        pl.pallas_call = orig
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_plain_block_with_the_kernels_gelu_matches_the_pallas_kernel(monkeypatch, kind, sign):
    x, weights = _rng_inputs(kind)
    _, mod, ref = BLOCKS[kind]
    monkeypatch.setattr(mod, "gelu_tanh", _sfu_gelu(sign))
    got = getattr(mod, ref)(torch.from_numpy(x).bfloat16(),
                            *(torch.from_numpy(w).bfloat16() for w in weights))
    monkeypatch.undo()
    plain = getattr(mod, ref)(torch.from_numpy(x).bfloat16(),
                              *(torch.from_numpy(w).bfloat16() for w in weights))
    want = _jax_bf16(kind)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert not torch.equal(got, plain)  # the GELU reached the block
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def test_gemm_s8_gelu_epilogue_twin_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (5, 64), generator=gen).to(torch.int8)
    b = torch.randint(-127, 128, (8, 64), generator=gen).to(torch.int8)
    rs, cs_ = torch.rand(5, generator=gen) * 1e-3, torch.rand(8, generator=gen) * 1e-3
    bias = torch.randn(8, generator=gen).bfloat16()
    before = g.LAUNCHES
    got = g.gemm_s8(a, b, rs, cs_, gelu_bias=bias)
    want = g.gelu_tanh(g.gemm_s8_ref(a, b, rs, cs_) + bias.float())
    assert torch.equal(got, want) and got.dtype == torch.float32
    assert g.LAUNCHES == before and not g._LIB.loaded
    for bad in (dict(gelu_bias=bias[:4]), dict(gelu_bias=bias, chunk=32)):
        with pytest.raises(ValueError):
            g.gemm_s8(a, b, rs, cs_, **bad)
    with pytest.raises(ValueError):  # batched operands have no GELU entry
        g.gemm_s8(a[None], b, rs[None], cs_, gelu_bias=bias)
