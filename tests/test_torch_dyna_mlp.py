"""The port's DynaMixer against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the "XS" setting of tools/parity_report.py (patches [4, 2], dims
[16, 32], depths [2, 2], segments [2, 4], hidden 2; img 32), added to both
packages' ``dynamlp_settings``: the same seed gives the same weights; the
JAX params, whose per-segment projections ``Wd.{s}`` are stacked
(seg, hidden, C) and whose ``attend.1`` is ``attend``, convert to the
port's state dict; float32 logits within 1e-4; bf16 and int8_mode() within
their bands; Predictor's batched answers equal single ones. The
weights="int8" state dict is bit-equal to JAX's at "XS" and at
DynaMixer-T, whose stacked (4, 8, 2, 192) ``Wd`` leaf is quantized with
one scale per (block, segment) matrix.
"""

import pytest

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp

SHAPE = (2, 3, 32, 32)


@pytest.fixture(autouse=True)
def xs_setting():
    with tp.dyna_xs():
        yield


def test_same_seed_same_weights():
    got = tp.check_same_seed(jm.DynaMixer, jt.DynaMixer, tp.DYNA)
    assert got["stages.1.1.layers.1.0.fn.DynaMixerOp_h.Wd.3.weight"].shape == (2, 32)
    assert got["stages.0.1.layers.0.0.fn.DynaMixerOp_w.attend.1.weight"].shape == (64, 16)


def test_state_dict_from_jax_equals_export():
    tp.check_convert("dyna_mlp", jm.DynaMixer, jt.DynaMixer, tp.DYNA)


def test_f32_logits_match_jax():
    tp.check_port_parity(jm.DynaMixer, jt.DynaMixer, tp.DYNA, SHAPE, name="dyna_mlp")


def test_bf16_logits_within_band_of_jax_f32():
    tp.check_bf16(jm.DynaMixer, jt.DynaMixer, tp.DYNA, (8, 3, 32, 32))


def test_int8_logits_within_band_of_jax_int8_mode():
    tp.check_int8(jm.DynaMixer, jt.DynaMixer, tp.DYNA, (8, 3, 32, 32))


@pytest.mark.parametrize("kw", [tp.DYNA, dict(model_name="T", num_classes=10)],
                         ids=["xs", "dyna_t"])
def test_int8_state_dict_equals_jax_dequantize_tree(kw):
    q = tp.check_int8_state_dict("dyna_mlp", jm.DynaMixer, jt.DynaMixer, kw)
    wd = q["stages.0.1.layers.2.0.fn.DynaMixerOp_h.Wd.5.weight" if kw["model_name"] == "T"
           else "stages.0.1.layers.1.0.fn.DynaMixerOp_h.Wd.1.weight"]
    if kw["model_name"] == "T":  # (4, 8, 2, 192) stacked: a scale a (block, segment)
        assert isinstance(wd, dict) and wd["scale"].shape == (1, 1)
        assert not isinstance(q["stages.0.1.layers.2.0.fn.DynaMixerOp_h.Wd.5.bias"], dict)
    else:  # (2, 2, 2, 16): too few
        assert not isinstance(wd, dict)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.DynaMixer, tp.DYNA, 32, opts)


def test_factory_options():
    tp.check_factory_device(jt.DynaMixer, tp.DYNA)
    with pytest.raises(ValueError):
        jt.DynaMixer(model_name="XXL", **tp.CPU)
    assert jt.DynaMixer(**tp.DYNA, **tp.CPU).name == "dyna_mlp"
