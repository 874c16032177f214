"""The port's S2-MLP v1 and v2 against jittor_mlp_tpu's, on the CPU
(tests/torch_parity.py).

At the small two-stage configuration of tools/parity_report.py (img 32,
patches [4, 2], d_model [32, 64], depths [2, 2]) and at channel widths
that split into unequal groups (30, 42): the same seed gives the same
weights; the JAX params convert to the port's state dict; float32 logits
within 1e-4; bf16 and int8_mode() within their bands; weights="int8"
bit-equal to JAX's; Predictor's batched answers equal single ones.
``spatial_shift1`` / ``spatial_shift2`` equal the JAX shifts and a numpy
functional-read definition bit for bit at C = 10 (groups 2, 3, 2, 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.models.s2_mlp_v1 import S2MLPv1 as JS2MLPv1
from jittor_mlp_tpu.ops import shift as jshift
from jittor_mlp_tpu_torch.models.s2_mlp_v1 import S2MLPv1
from jittor_mlp_tpu_torch.ops import shift as tshift

UNEQUAL = {**tp.S2, "d_model": [30, 42]}
FAMILIES = {"s2_mlp_v1": (JS2MLPv1, S2MLPv1), "s2_mlp_v2": (jm.S2MLPv2, jt.S2MLPv2)}
VERSIONS = pytest.mark.parametrize("name", list(FAMILIES), ids=["v1", "v2"])
CONFIGS = pytest.mark.parametrize("kw", [tp.S2, UNEQUAL], ids=["small", "unequal_groups"])
SHAPE = (2, 3, 32, 32)


@VERSIONS
@CONFIGS
def test_same_seed_same_weights(name, kw):
    got = tp.check_same_seed(*FAMILIES[name], kw)
    assert "stages.1.1.model.1.1.fn.3.weight" in got and "mlp_head.1.weight" in got


@VERSIONS
@CONFIGS
def test_state_dict_from_jax_equals_export(name, kw):
    tp.check_convert(name, *FAMILIES[name], kw)


@VERSIONS
@CONFIGS
def test_f32_logits_match_jax(name, kw):
    tp.check_port_parity(*FAMILIES[name], kw, SHAPE, name=name)


@VERSIONS
def test_bf16_logits_within_band_of_jax_f32(name):
    tp.check_bf16(*FAMILIES[name], tp.S2, (8, 3, 32, 32))


@VERSIONS
def test_int8_logits_within_band_of_jax_int8_mode(name):
    tp.check_int8(*FAMILIES[name], tp.S2, (8, 3, 32, 32))


@VERSIONS
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(name, dtype):
    q = tp.check_int8_state_dict(name, *FAMILIES[name], tp.S2, dtype)
    ff = q["stages.1.1.model.0.1.fn.0.weight"]  # stacked (2, 128, 64): a scale a row
    assert isinstance(ff, dict) and ff["scale"].shape == (128, 1)
    assert not isinstance(q["stages.0.1.model.0.0.norm.weight"], dict)


@VERSIONS
@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(name, opts):
    tp.check_predictor(FAMILIES[name][1], tp.S2, 32, opts)


def _functional_shift(x, axes):
    """The reference's four in-place assignments, each read from the
    unshifted input (numpy, NHWC)."""
    out = x.copy()
    c = x.shape[-1]
    groups = [slice(0, c // 4), slice(c // 4, c // 2), slice(c // 2, 3 * c // 4),
              slice(3 * c // 4, c)]
    for g, (axis, d) in zip(groups, [(axes[0], 1), (axes[0], -1), (axes[1], 1), (axes[1], -1)]):
        dst = [slice(None)] * 4
        src = [slice(None)] * 4
        dst[axis], src[axis] = (slice(1, None), slice(None, -1)) if d == 1 else \
            (slice(None, -1), slice(1, None))
        dst[3] = src[3] = g
        out[tuple(dst)] = x[tuple(src)]
    return out


@pytest.mark.parametrize("fn,axes", [("spatial_shift1", (1, 2)), ("spatial_shift2", (2, 1))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_shifts_match_jax(fn, axes, dtype):
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 10)).astype(np.float32)
    want = np.asarray(getattr(jshift, fn)(jnp.asarray(x, getattr(jnp, dtype))), np.float32)
    got = getattr(tshift, fn)(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), _functional_shift(x, axes))
        assert not np.array_equal(got.numpy(), x)


def test_factory_options():
    tp.check_factory_device(jt.S2MLPv2, tp.S2)
    for factory in (S2MLPv1, jt.S2MLPv2):
        with pytest.raises(NotImplementedError):
            factory(**tp.S2, block_runner=lambda *a: None, **tp.CPU)
        with pytest.raises(ValueError):
            factory(**{**tp.S2, "depth": [2]}, **tp.CPU)
    wide = jt.S2MLPv1_wide(num_classes=10, device="meta")
    assert (wide.name, len(wide.stages[0][1].model)) == ("s2_mlp_v1", 12)
    assert wide.stages[0][0].weight.shape == (768, 3, 16, 16)
    deep = jt.S2MLPv1_deep(num_classes=10, device="meta")
    assert len(deep.stages[0][1].model) == 36 and jt.S2MLPv2(**tp.S2, **tp.CPU).name == "s2_mlp_v2"
