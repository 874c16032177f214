"""The port's RaftMLP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small two-level configuration of tools/parity_report.py (img 16,
dims 16 and 32, patches 4 and 2, raft 2): all four token mixing types and
the three other head variants (gap and shortcut) give the same weights
from the same seed, convert from the JAX params and match the JAX float32
logits within 1e-4; the interpolated level (patch 3 on a 16-pixel image:
a bilinear upsample to 18) within 5e-4, as the JAX package's own test
holds it. The default configuration also holds bf16 and int8_mode() in
their bands, weights="int8" bit-equal to JAX's and Predictor's batched
answers equal to single ones.
"""

import pytest

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp

MIXING = ["ser_pm", "sep_ln_codim_tm", "sep_ln_ch_tm", "original_tm"]
HEADS = [(True, True), (False, False), (True, False)]
CONFIGS = ([{**tp.RAFT, "token_mixing_type": m} for m in MIXING]
           + [{**tp.RAFT, "gap": g, "shortcut": s} for g, s in HEADS])
IDS = MIXING + [f"gap_{g}_shortcut_{s}" for g, s in HEADS]
ALL = pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
INTERPOLATED = dict(layers=[{"depth": 1, "dim": 16, "patch_size": 3, "raft_size": 2}],
                    image_size=16, num_classes=10)
SHAPE = (2, 3, 16, 16)


@ALL
def test_same_seed_same_weights(kw):
    got = tp.check_same_seed(jm.RaftMLP, jt.RaftMLP, kw)
    assert "levels.1.fn.2.3.fn.3.weight" in got and "levels.0.fn.1.weight" in got
    assert ("heads.1.1.weight" in got) == kw.get("shortcut", True)


@ALL
def test_state_dict_from_jax_equals_export(kw):
    tp.check_convert("raft_mlp", jm.RaftMLP, jt.RaftMLP, kw)


@ALL
def test_f32_logits_match_jax(kw):
    tp.check_port_parity(jm.RaftMLP, jt.RaftMLP, kw, SHAPE, name="raft_mlp")


def test_f32_interpolated_level_matches_jax():
    tp.check_same_seed(jm.RaftMLP, jt.RaftMLP, INTERPOLATED)
    tp.check_port_parity(jm.RaftMLP, jt.RaftMLP, INTERPOLATED, SHAPE, tol=5e-4,
                         name="raft_mlp interpolated")


def test_bf16_logits_within_band_of_jax_f32():
    tp.check_bf16(jm.RaftMLP, jt.RaftMLP, tp.RAFT, (8, 3, 16, 16))


def test_int8_logits_within_band_of_jax_int8_mode():
    tp.check_int8(jm.RaftMLP, jt.RaftMLP, tp.RAFT, (8, 3, 16, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    q = tp.check_int8_state_dict("raft_mlp", jm.RaftMLP, jt.RaftMLP, tp.RAFT, dtype)
    assert not isinstance(q["classifier.weight"], dict)  # (10, 32 · 2²): too few
    ff = q["levels.1.fn.2.5.fn.0.weight"]  # a block's own (128, 32) leaf, not stacked
    assert isinstance(ff, dict) and ff["scale"].shape == (128, 1)
    assert not isinstance(q["levels.0.fn.2.1.fn.0.weight"], dict)  # (16, 8): too few


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.RaftMLP, tp.RAFT, 16, opts)


def test_factory_options():
    tp.check_factory_device(jt.RaftMLP, tp.RAFT)
    with pytest.raises(ValueError):
        jt.RaftMLP(**tp.RAFT, token_mixing_type="nope", **tp.CPU)
    # dropout and drop_path_rate are accepted and change nothing in eval
    m = jt.RaftMLP(**tp.RAFT, dropout=0.5, drop_path_rate=0.2, **tp.CPU)
    assert m.name == "raft_mlp" and sorted(m.state_dict()) == sorted(
        jt.RaftMLP(**tp.RAFT, **tp.CPU).state_dict())
