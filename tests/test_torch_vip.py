"""The port's ViP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small configuration of tools/parity_report.py (img 32, patch 8,
d_model 32, depth 2, segments 4), weighted (split attention) and plain:
the same seed gives the same weights; the JAX params convert to the port's
state dict; float32 logits within 1e-4 of the JAX forward; bf16 and
int8_mode() within their bands; the weights="int8" state dict bit-equal to
JAX's; Predictor's batched answers equal single ones. ``nnf.softmax``
against ``jax.nn.softmax``.
"""

import jax
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu_torch.core import nnf

PLAIN = {**tp.VIP, "weighted": False}
CONFIGS = pytest.mark.parametrize("kw", [tp.VIP, PLAIN], ids=["weighted", "plain"])
SHAPE = (2, 3, 32, 32)


@CONFIGS
def test_same_seed_same_weights(kw):
    got = tp.check_same_seed(jm.ViP, jt.ViP, kw)
    assert ("blocks.model.1.0.fn.0.split_attention.mlp2.weight" in got) == kw.get("weighted", True)
    assert got["blocks.model.0.0.fn.0.fns.0.1.weight"].shape == (16, 16)  # Linear(H·s)


@CONFIGS
def test_state_dict_from_jax_equals_export(kw):
    tp.check_convert("vip", jm.ViP, jt.ViP, kw)


@CONFIGS
def test_f32_logits_match_jax(kw):
    tp.check_port_parity(jm.ViP, jt.ViP, kw, SHAPE, name="vip")


@CONFIGS
def test_bf16_logits_within_band_of_jax_f32(kw):
    tp.check_bf16(jm.ViP, jt.ViP, kw, (8, 3, 32, 32))


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw):
    tp.check_int8(jm.ViP, jt.ViP, kw, (8, 3, 32, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    kw = {**tp.VIP, "d_model": 64, "segments": 8}  # Linear(H·s) 32 × 32 a block
    q = tp.check_int8_state_dict("vip", jm.ViP, jt.ViP, kw, dtype)
    mix = q["blocks.model.1.0.fn.0.fns.0.1.weight"]  # stacked (2, 32, 32): a scale a row
    assert isinstance(mix, dict) and mix["scale"].shape == (32, 1)
    assert not isinstance(q["blocks.model.0.0.norm.weight"], dict)  # (2, 64): too few


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.ViP, tp.VIP, 32, opts)


def test_softmax_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    for dim in (-1, 1):
        want = np.asarray(jax.nn.softmax(x, axis=dim))
        got = nnf.softmax(torch.from_numpy(x), dim=dim).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_factory_options():
    tp.check_factory_device(jt.ViP, tp.VIP)
    with pytest.raises(NotImplementedError):
        jt.ViP(**tp.VIP, block_runner=lambda *a: None, **tp.CPU)
    with pytest.raises(ValueError):
        jt.ViP(**{**tp.VIP, "segments": 5}, **tp.CPU)
    assert jt.ViP(**tp.VIP, **tp.CPU).name == "vip"
