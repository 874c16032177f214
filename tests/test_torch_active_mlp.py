"""The port's ActiveMLP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small configuration of tools/parity_report.py (depths [2, 2], dims
[16, 32], share [2, 4], intv 2; img 32), at tests/test_cycle_active.py's
one-stage depth 4 (offsets made again mid-stage) and with share 1: the same
seed gives the same weights; the JAX params convert to the port's state
dict; float32 logits within 1e-4; bf16 and int8_mode() within their bands;
weights="int8" bit-equal to JAX's; Predictor's batched answers equal single
ones.

``offset_band=2``, with ``offset_layer.1`` scaled so that offsets pass ±2:
float32 logits within 1e-4 of JAX's ``offset_band=2`` (its banded sampler
with saturation), and away from the exact sample. After an in-place change
of the offset weights the port's "auto" output equals its None output and
JAX's exact forward on the changed weights: the port samples exactly
whatever the weights become, where the JAX "auto" band is taken from the
weights it was given.
"""

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.models.active_mlp import ActiveMLP as JActiveMLP
from jittor_mlp_tpu_torch.models import active_mlp as tactive
from jittor_mlp_tpu_torch.models.active_mlp import ActiveMLP

INTV = dict(depths=[4], embed_dims=[16], mlp_ratios=[2], share_dims=[2], intv=2,
            num_classes=10)
SHARE1 = {**tp.ACTIVE, "share_dims": [1, 1]}
CONFIGS = pytest.mark.parametrize("kw", [tp.ACTIVE, INTV, SHARE1],
                                  ids=["small", "intv_depth4", "share1"])
SHAPE = (2, 3, 32, 32)


@CONFIGS
def test_same_seed_same_weights(kw):
    got = tp.check_same_seed(JActiveMLP, ActiveMLP, kw)
    share = kw["share_dims"][0]
    assert got["blocks.0.0.offset_layer.1.weight"].shape == (2 * 16 // share, 16)
    assert got["pos_blocks.0.proj.weight"].shape == (16, 1, 3, 3)


@CONFIGS
def test_state_dict_from_jax_equals_export(kw):
    tp.check_convert("active_mlp", JActiveMLP, ActiveMLP, kw)


@CONFIGS
def test_f32_logits_match_jax(kw):
    tp.check_port_parity(JActiveMLP, ActiveMLP, kw, SHAPE, name="active_mlp")


@CONFIGS
def test_bf16_logits_within_band_of_jax_f32(kw):
    tp.check_bf16(JActiveMLP, ActiveMLP, kw, (8, 3, 32, 32))


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw):
    tp.check_int8(JActiveMLP, ActiveMLP, kw, (8, 3, 32, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    tp.check_int8_state_dict("active_mlp", JActiveMLP, ActiveMLP, tp.ACTIVE, dtype)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(ActiveMLP, tp.ACTIVE, 32, opts)


def _scaled_offsets(sd, factor):
    return {k: (v * factor if k.endswith("offset_layer.1.weight") else v) for k, v in sd.items()}


def _record_offsets(monkeypatch):
    """The largest |offset| the port's ATM ops read, by wrapping atm_op."""
    seen = []

    def atm_op(x, offset, *args, **kwargs):
        seen.append(float(offset.abs().max()))
        return orig(x, offset, *args, **kwargs)

    orig = tactive.atm_op
    monkeypatch.setattr(tactive, "atm_op", atm_op)
    return seen


def test_offset_band_2_matches_jax_banded_sampler(monkeypatch):
    """offset_layer.1 ×40: offsets pass ±2, the port clamps them as JAX's
    offset_band=2 saturates them, and both differ from the exact sample."""
    from jittor_mlp_tpu import config as jconfig
    from jittor_mlp_tpu_torch import config

    sd = _scaled_offsets(ActiveMLP(**tp.ACTIVE, **tp.CPU).export_torch_state_dict(), 40.0)
    x = tp.images(SHAPE)
    jmodel = JActiveMLP(**tp.ACTIVE, offset_band=2).load_torch_state_dict(sd)
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    seen = _record_offsets(monkeypatch)
    banded = ActiveMLP(**tp.ACTIVE, offset_band=2, **tp.CPU).load_torch_state_dict(sd).eval()
    exact = ActiveMLP(**tp.ACTIVE, offset_band=None, **tp.CPU).load_torch_state_dict(sd).eval()
    with config.parity_mode(), torch.inference_mode():
        got = banded(x).numpy()
        far = exact(x).numpy()
    assert max(seen) > 2
    tp.assert_close(got, want, tol=1e-4, name="active_mlp offset_band=2")
    assert np.abs(far - got).max() > 1e-3 * np.abs(got).max()


def test_auto_equals_none_after_in_place_change_of_offset_weights(monkeypatch):
    """Scaling offset_layer.1 in place (no load, no rebuild) after the model
    is built: "auto" gives None's output bit for bit, and JAX's exact
    forward on the changed weights within 1e-4."""
    from jittor_mlp_tpu import config as jconfig
    from jittor_mlp_tpu_torch import config

    auto = ActiveMLP(**tp.ACTIVE, **tp.CPU).eval()  # offset_band="auto", the default
    none = ActiveMLP(**tp.ACTIVE, offset_band=None, **tp.CPU).eval()
    with torch.no_grad():
        for m in (auto, none):
            for stage in m.blocks:
                for blk in stage:
                    if hasattr(blk, "offset_layer"):
                        blk.offset_layer[1].weight.mul_(25.0)
    x = tp.images(SHAPE)
    seen = _record_offsets(monkeypatch)
    with config.parity_mode(), torch.inference_mode():
        got = auto(x)
        assert torch.equal(got, none(x))
    assert max(seen) > 8  # offsets past the 8 × 8 map
    jmodel = JActiveMLP(**tp.ACTIVE, offset_band=None).load_torch_state_dict(
        auto.export_torch_state_dict())
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    tp.assert_close(got.numpy(), want, tol=1e-4, name="active_mlp auto after change")


@pytest.mark.parametrize("factory", ["ActivexTiny", "ActiveTiny", "ActiveSmall", "ActiveBase",
                                     "ActiveLarge"])
def test_factories_match_jax_layout(factory):
    want = getattr(jm.models.active_mlp, factory)(num_classes=10)._init_sd
    got = getattr(jt.models.active_mlp, factory)(num_classes=10, **tp.CPU).state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


def test_factory_options():
    tp.check_factory_device(ActiveMLP, tp.ACTIVE)
    for f in ("ActiveSmall", "ActiveBase", "ActiveLarge"):
        assert getattr(jt, f) is getattr(tactive, f)
    assert not hasattr(jt, "ActivexTiny")  # through models.active_mlp, as in JAX
    assert ActiveMLP(**tp.ACTIVE, **tp.CPU).name == "active_mlp"
    with pytest.raises(ValueError, match="offset_band"):
        ActiveMLP(**tp.ACTIVE, offset_band="wide", **tp.CPU)
