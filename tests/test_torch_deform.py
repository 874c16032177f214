"""The port's ops/deform.py against jittor_mlp_tpu.ops.deform, on the CPU.

Inputs come from a seeded numpy generator and go to both sides; the JAX
side runs under parity_mode() in float32.

- ``cycle_fc`` against JAX ``cycle_fc`` (K masked products, where the port
  shifts once and runs one product, so the sums run in another order):
  within 1e-4 of max|ref|, kernels (1, 3) and (3, 1), C a multiple of 3 and
  not, with and without bias; its shift against the reference's offset
  buffer, read channel by channel; ``cycle_offset`` equal to JAX's
  ``_gen_offset``; no int8 under ``int8_mode()``.
- ``atm_sample`` against JAX ``_hat_sample_1d`` (one offset a group of
  ``share`` channels) and ``_linear_sample_1d`` (the offsets repeated over
  each group), axes H and W, share 1, 2 and 4, offsets that leave the map:
  within 1e-5 of max|ref|. In bf16 at H = 56, where a bf16 position would
  move in quarter pixels, held to the answer with float32 positions.
- ``band``: offsets beyond ±2 clamped, against JAX
  ``_hat_sample_1d_banded(saturate=True)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.models.cycle_mlp import _gen_offset
from jittor_mlp_tpu.ops import deform as jdeform
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.ops import deform as tdeform


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _within(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{err:.3e} > {tol} of {np.abs(want).max():.3e}"


def _cycle_inputs(C, bias, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 7, 6, C)).astype(np.float32)
    w = r.standard_normal((C + 2, C, 1, 1)).astype(np.float32)
    b = r.standard_normal(C + 2).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("C", [12, 10], ids=["c12", "c10"])
@pytest.mark.parametrize("kernel", [(1, 3), (3, 1)], ids=["k1x3", "k3x1"])
def test_cycle_fc_matches_jax(kernel, C, bias):
    x, w, b = _cycle_inputs(C, bias)
    p = {"weight": jnp.asarray(w)}
    if bias:
        p["bias"] = jnp.asarray(b)
    with jconfig.parity_mode():
        want = np.asarray(jdeform.cycle_fc(p, jnp.asarray(x), kernel))
    with config.parity_mode():
        got = tdeform.cycle_fc(_t(x), _t(w), None if b is None else _t(b), kernel)
    _within(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("kernel", [(1, 3), (3, 1), (1, 7)], ids=["k1x3", "k3x1", "k1x7"])
def test_cycle_shift_reads_the_offset_buffer(kernel):
    """Channel i of the shift is x shifted by the reference's offset buffer
    (Δy, Δx of channel i), zero outside."""
    C = 11
    x = np.random.default_rng(1).standard_normal((2, 8, 9, C)).astype(np.float32)
    got = tdeform.cycle_shift(_t(x), kernel).numpy()
    off = tdeform.cycle_offset(C, *kernel)[0, :, 0, 0].reshape(C, 2)
    want = np.zeros_like(x)
    for i, (dy, dx) in enumerate(off.astype(int)):
        for p in range(8):
            for q in range(9):
                if 0 <= p + dy < 8 and 0 <= q + dx < 9:
                    want[:, p, q, i] = x[:, p + dy, q + dx, i]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,kh,kw", [(16, 1, 3), (16, 3, 1), (10, 1, 3), (7, 5, 1)])
def test_cycle_offset_equals_jax_gen_offset(c, kh, kw):
    np.testing.assert_array_equal(tdeform.cycle_offset(c, kh, kw), _gen_offset(c, kh, kw))


def test_deform_products_stay_out_of_int8():
    """cycle_fc's and atm_op's products are jnp.matmul in JAX, not _dense:
    int8_mode() changes nothing."""
    x, w, b = _cycle_inputs(12, True)
    off = np.random.default_rng(2).standard_normal((2, 7, 6, 6)).astype(np.float32)
    plain = (tdeform.cycle_fc(_t(x), _t(w), _t(b), (1, 3)),
             tdeform.atm_op(_t(x), _t(off), _t(w), _t(b), "w", share=2))
    with config.int8_mode():
        again = (tdeform.cycle_fc(_t(x), _t(w), _t(b), (1, 3)),
                 tdeform.atm_op(_t(x), _t(off), _t(w), _t(b), "w", share=2))
    for p, a in zip(plain, again):
        assert torch.equal(p, a)


def _atm_inputs(share, scale=3.0, shape=(2, 6, 7, 8), seed=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32)
    # offsets up to several pixels: many samples leave the map
    off = (r.standard_normal((*shape[:3], shape[3] // share)) * scale).astype(np.float32)
    return x, off


@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("axis", [1, 2], ids=["h", "w"])
def test_atm_sample_matches_jax_hat_sample(axis, share):
    x, off = _atm_inputs(share)
    n = x.shape[axis]
    pos = np.arange(n).reshape([-1 if a == axis else 1 for a in range(4)]) + off
    assert ((pos < 0) | (pos > n - 1)).any()  # some samples leave the map
    rep = np.repeat(off, share, axis=-1)
    with jconfig.parity_mode():
        want = np.asarray(jdeform._hat_sample_1d(jnp.asarray(x), jnp.asarray(rep), axis, share))
    got = tdeform.atm_sample(_t(x), _t(off), axis, share).numpy()
    _within(got, want, 1e-5)


@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("axis", [1, 2], ids=["h", "w"])
def test_atm_sample_matches_jax_linear_sample(axis, share):
    x, off = _atm_inputs(share, seed=4)
    rep = np.repeat(off, share, axis=-1)
    with jconfig.parity_mode():
        want = np.asarray(jdeform._linear_sample_1d(jnp.asarray(x), jnp.asarray(rep), axis))
    got = tdeform.atm_sample(_t(x), _t(off), axis, share).numpy()
    _within(got, want, 1e-5)


@pytest.mark.parametrize("axis", [1, 2], ids=["h", "w"])
def test_atm_sample_bf16_keeps_float32_positions(axis):
    """bf16 x and offsets at n = 56: i + offset rounded to bf16 moves the
    position in steps of 0.25 beyond index 32, so a bf16 position would
    sample elsewhere. The port's bf16 sample is the float32-position answer
    on the same bf16 values, rounded once to bf16, within one bf16 ulp."""
    x, off = _atm_inputs(2, scale=1.5, shape=(2, 56, 56, 8), seed=5)
    xb, offb = _t(x, torch.bfloat16), _t(off, torch.bfloat16)
    n = 56
    idx = torch.arange(n).reshape([-1 if a == axis else 1 for a in range(4)])
    pos_f32 = idx + offb.float()
    pos_bf16 = (idx.to(torch.bfloat16) + offb).float()
    assert (pos_f32 != pos_bf16).float().mean() > 0.1  # bf16 positions would round off
    got = tdeform.atm_sample(xb, offb, axis, share=2)
    assert got.dtype == torch.bfloat16
    rep = np.repeat(offb.float().numpy(), 2, axis=-1)
    with jconfig.parity_mode():
        want = np.asarray(jdeform._linear_sample_1d(
            jnp.asarray(xb.float().numpy()), jnp.asarray(rep), axis))
    want_b = _t(want, torch.bfloat16).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want_b) <= ulp).all()


@pytest.mark.parametrize("share", [1, 4])
@pytest.mark.parametrize("axis", [1, 2], ids=["h", "w"])
def test_atm_sample_band_clamps_like_jax_banded_sampler(axis, share):
    """band=2 with offsets reaching ±9: clamped to ±2 and then sampled
    exactly, which JAX's banded sampler with saturation computes; and away
    from the exact sample (the clamp engaged)."""
    x, off = _atm_inputs(share, scale=4.0, shape=(2, 9, 10, 8), seed=6)
    assert np.abs(off).max() > 2
    rep = np.repeat(off, share, axis=-1)
    with jconfig.parity_mode():
        want = np.asarray(jdeform._hat_sample_1d_banded(
            jnp.asarray(x), jnp.asarray(rep), axis, share=share, band=2, saturate=True))
    got = tdeform.atm_sample(_t(x), _t(off), axis, share, band=2).numpy()
    _within(got, want, 1e-5)
    exact = tdeform.atm_sample(_t(x), _t(off), axis, share).numpy()
    assert np.abs(exact - got).max() > 1e-2


def test_atm_op_matches_jax():
    x, off = _atm_inputs(2, seed=7)
    r = np.random.default_rng(8)
    w = r.standard_normal((8, 8, 1, 1)).astype(np.float32)
    b = r.standard_normal(8).astype(np.float32)
    rep = np.repeat(off, 2, axis=-1)
    for dim in ("h", "w"):
        with jconfig.parity_mode():
            want = np.asarray(jdeform.atm_op({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                             jnp.asarray(x), jnp.asarray(rep), dim, share=2,
                                             band=None))
        got = tdeform.atm_op(_t(x), _t(off), _t(w), _t(b), dim, share=2).numpy()
        _within(got, want, 1e-5)
