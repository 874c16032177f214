"""The port's axial shift against jittor_mlp_tpu's, on the CPU.

The JAX side runs both its XLA ``ops.shift.axial_shift`` and the Pallas
kernel ``axial_shift_pallas`` in interpret mode (as tests/test_pallas.py
does). The port's plain twin (``ops.shift.axial_shift``) and the kernel's
wrapper on a CPU tensor (which runs that twin) must equal both exactly:
the shift only moves values, so float32 and bf16 compare bit for bit. The
backward of the wrapper's ``autograd.Function`` (the shift at sign -1)
equals ``jax.grad`` through the Pallas custom VJP, exactly. Shapes cover
both axes, H ≠ W, ragged groups (C = 20 at shift 3: 7, 7, 6 channels),
fewer groups than the shift (C = 16 at shift 5: four groups) and C < shift.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.shift_kernel as jsk
from jittor_mlp_tpu.ops.shift import axial_shift as jax_axial_shift
from jittor_mlp_tpu_torch.ops import shift as tshift
from jittor_mlp_tpu_torch.ops.kernels import axial_shift as tks

CASES = {  # name: (shape (B, H, W, C), shift_size)
    "c10_s3": ((2, 6, 7, 10), 3),
    "c16_s5_four_groups": ((2, 5, 6, 16), 5),
    "c20_s3_ragged": ((2, 6, 5, 20), 3),
    "h_ne_w": ((1, 4, 9, 12), 5),
    "c_lt_shift": ((2, 5, 4, 3), 5),
}
AXES = pytest.mark.parametrize("axis", [1, 2], ids=["H", "W"])
SHAPES = pytest.mark.parametrize("case", list(CASES))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _interpret(fn, *args):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


@SHAPES
@AXES
def test_shift_equals_jax_xla_and_pallas(case, axis):
    shape, shift = CASES[case]
    x = _x(shape)
    want_xla = np.asarray(jax_axial_shift(jnp.asarray(x), shift, axis))
    want_pallas = np.asarray(_interpret(jsk.axial_shift_pallas, jnp.asarray(x), shift, axis))
    np.testing.assert_array_equal(want_pallas, want_xla)
    before = tks.LAUNCHES
    for got in (tshift.axial_shift(torch.from_numpy(x), shift, axis),
                tks.axial_shift(torch.from_numpy(x), shift, axis),
                tks.shift(torch.from_numpy(x), shift, axis, 1)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want_xla)
    assert tks.LAUNCHES == before  # CPU tensors run the twin


@SHAPES
@AXES
def test_backward_equals_jax_custom_vjp(case, axis):
    """d/dx sum(shift(x)·w): the autograd.Function's backward (the shift at
    sign -1 on w) against jax.grad through axial_shift_pallas's custom VJP,
    and against autograd of the plain twin."""
    shape, shift = CASES[case]
    x, w = _x(shape), _x(shape, seed=1)
    want = np.asarray(_interpret(
        jax.grad(lambda v: jnp.sum(jsk.axial_shift_pallas(v, shift, axis) * w)), jnp.asarray(x)))
    for fn in (tks.axial_shift, tshift.axial_shift):
        xt = torch.from_numpy(x).requires_grad_()
        (g,) = torch.autograd.grad((fn(xt, shift, axis) * torch.from_numpy(w)).sum(), xt)
        np.testing.assert_array_equal(g.numpy(), want)
    np.testing.assert_array_equal(
        tks.shift(torch.from_numpy(w), shift, axis, -1).numpy(), want)


@AXES
def test_bf16_is_a_copy(axis):
    shape, shift = CASES["c20_s3_ragged"]
    x = _x(shape, seed=2)
    want = np.asarray(jax_axial_shift(jnp.asarray(x, jnp.bfloat16), shift, axis)
                      .astype(jnp.float32))
    got = tks.axial_shift(torch.from_numpy(x).bfloat16(), shift, axis)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_group_offsets():
    """Channel group g reads from p + shift//2 - g: at shift 5 and C = 16
    (group 4), a one-hot along W moves by +2, +1, 0, -1 positions."""
    x = torch.zeros(1, 1, 7, 16)
    x[0, 0, 3] = 1.0
    out = tks.axial_shift(x, 5, 2)[0, 0]
    for g, s in enumerate((2, 1, 0, -1)):
        for c in range(4 * g, 4 * g + 4):
            assert out[:, c].nonzero().flatten().tolist() == [3 - s], (g, c)
    # shift 1 is the identity; a shift longer than the axis gives zeros
    assert torch.equal(tks.axial_shift(x, 1, 1), x)
    assert torch.equal(tshift._shift_zero(x, 2, 7), torch.zeros_like(x))
    assert torch.equal(tshift._shift_zero(x, 2, -9), torch.zeros_like(x))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError):
        tks.shift(x[0], 3, 1)  # not (B, H, W, C)
    with pytest.raises(ValueError):
        tks.shift(x, 3, 3)  # no such axis
    with pytest.raises(ValueError):
        tks.shift(x, 3, 1, sign=2)
    with pytest.raises(ValueError):
        tks.shift(x.to("meta"), 3, 1)  # neither the CPU nor a card: no fallback
