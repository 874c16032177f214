"""The port's CycleMLP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small configuration of tools/parity_report.py (layers [1, 2], dims
[16, 32]: neither a multiple of CycleFC's 3; transitions [True, True];
img 32), with ``skip_lam`` 2 and ``qkv_bias``, and at dims [12, 24]
(multiples of 3): the same seed gives the same weights; the JAX params
convert to the port's state dict, each CycleFC's ``offset`` buffer made
again; float32 logits within 1e-4; bf16 and int8_mode() within their
bands; weights="int8" bit-equal to JAX's (the offsets kept out of int8);
Predictor's batched answers equal single ones. The offsets are buffers,
not parameters, equal to the reference's.
"""

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.models.cycle_mlp import CycleNet as JCycleNet
from jittor_mlp_tpu.models.cycle_mlp import _gen_offset
from jittor_mlp_tpu_torch.models.cycle_mlp import CycleNet

LAM = {**tp.CYCLE, "skip_lam": 2.0, "qkv_bias": True}
THREES = {**tp.CYCLE, "embed_dims": [12, 24]}
CONFIGS = pytest.mark.parametrize("kw", [tp.CYCLE, LAM, THREES],
                                  ids=["small", "skip_lam_qkv_bias", "dims_of_3"])


@CONFIGS
def test_same_seed_same_weights(kw):
    got = tp.check_same_seed(JCycleNet, CycleNet, kw)
    d = kw["embed_dims"][1]
    np.testing.assert_array_equal(got["network.2.1.attn.sfc_w.offset"], _gen_offset(d, 3, 1))
    assert got["network.1.proj.weight"].shape == (d, kw["embed_dims"][0], 3, 3)
    assert ("network.0.0.attn.mlp_c.bias" in got) == kw.get("qkv_bias", False)


@CONFIGS
def test_state_dict_from_jax_equals_export(kw):
    tp.check_convert("cycle_mlp", JCycleNet, CycleNet, kw)


@CONFIGS
def test_f32_logits_match_jax(kw):
    tp.check_port_parity(JCycleNet, CycleNet, kw, (2, 3, 32, 32), name="cycle_mlp")


@CONFIGS
def test_bf16_logits_within_band_of_jax_f32(kw):
    tp.check_bf16(JCycleNet, CycleNet, kw, (8, 3, 32, 32))


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw):
    tp.check_int8(JCycleNet, CycleNet, kw, (8, 3, 32, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    q = tp.check_int8_state_dict("cycle_mlp", JCycleNet, CycleNet, tp.CYCLE, dtype)
    assert not any(isinstance(v, dict) for k, v in q.items() if k.endswith(".offset"))


def test_int8_state_dict_b1_keeps_the_offsets_out():
    """CycleMLP-B1: stage 2's four stacked offsets (4, 1, 640, 1, 1) would
    be an eligible leaf; JAX holds no offsets in its params, and the port
    quantizes none."""
    q = tp.check_int8_state_dict("cycle_mlp", jm.CycleMLP_B1, jt.CycleMLP_B1,
                                 dict(num_classes=10))
    offsets = [k for k in q if k.endswith(".offset")]
    assert len(offsets) == 2 * 10 and not any(isinstance(q[k], dict) for k in offsets)
    assert isinstance(q["network.4.3.attn.sfc_h.weight"], dict)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(CycleNet, tp.CYCLE, 32, opts)


def test_offsets_are_buffers_not_parameters():
    m = CycleNet(**tp.CYCLE, **tp.CPU)
    names = {k for k, _ in m.named_parameters()}
    buffers = dict(m.named_buffers())
    assert set(buffers) == {k for k in m.state_dict() if k.endswith(".offset")} != set()
    assert not names & set(buffers)
    sd = m.export_torch_state_dict(tensors=False)
    assert m.param_count() == sum(v.size for k, v in sd.items() if k not in buffers)
    for k, v in buffers.items():
        kh, kw = (1, 3) if ".sfc_h." in k else (3, 1)
        np.testing.assert_array_equal(v.numpy(), _gen_offset(v.shape[1] // 2, kh, kw))


@pytest.mark.parametrize("factory", ["CycleMLP_B1", "CycleMLP_B2", "CycleMLP_B3",
                                     "CycleMLP_B4", "CycleMLP_B5"])
def test_b_factories_match_jax_layout(factory):
    want = getattr(jm, factory)(num_classes=10)._init_sd
    got = getattr(jt, factory)(num_classes=10, **tp.CPU).state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


def test_no_transition_between_equal_stages():
    """transitions [False, True] with equal widths: the stages take slots 0
    and 1, with no stride-2 conv between; against JAX."""
    kw = {**tp.CYCLE, "embed_dims": [16, 16], "transitions": [False, True]}
    assert len(CycleNet(**kw, **tp.CPU).network) == 2
    tp.check_convert("cycle_mlp", JCycleNet, CycleNet, kw)
    tp.check_port_parity(JCycleNet, CycleNet, kw, (2, 3, 32, 32), name="cycle_mlp")


def test_factory_options():
    tp.check_factory_device(CycleNet, tp.CYCLE)
    tp.check_factory_device(jt.CycleMLP_B1, dict(num_classes=10))
    assert CycleNet(**tp.CYCLE, **tp.CPU).name == "cycle_mlp"
