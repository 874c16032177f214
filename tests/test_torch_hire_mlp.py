"""The port's HireMLP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small configuration of tools/parity_report.py (d_model [16, 32],
h = w = [4, 3], steps [2, 1], interval 2, depths [2, 3]; img 32: stage 0
at 8 × 8, a multiple of 4, pads a full extra region; stage 1 at 4 × 4 pads
2), in each of the four padding types and with ``patcher_norm``: the same
seed gives the same weights; the JAX params convert to the port's state
dict (the last stage's unused ``patch_merge`` from the JAX init template,
as JAX's export takes it); float32 logits within 1e-4; bf16 and
int8_mode() within their bands; weights="int8" bit-equal to JAX's (the
unused merge is kept out of int8, as JAX never holds it); Predictor's
batched answers equal single ones; the end padding equals ``np.pad``'s,
also where it is longer than the side.
"""

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.models.hire_mlp import PADDING_TYPES, _pad_end

PADS = pytest.mark.parametrize("padding_type", PADDING_TYPES)
NORM = {**tp.HIRE, "patcher_norm": True, "padding_type": "reflect"}


@PADS
def test_f32_logits_match_jax(padding_type):
    kw = {**tp.HIRE, "padding_type": padding_type}
    tp.check_port_parity(jm.HireMLP, jt.HireMLP, kw, (2, 3, 32, 32), name="hire_mlp")


def test_padding_types_differ():
    """The four modes give four different answers at these shapes: each
    parity case above checks its own mode."""
    x = tp.images((2, 3, 32, 32))
    with torch.inference_mode():
        outs = [jt.HireMLP(**tp.HIRE, padding_type=p, **tp.CPU).eval()(x) for p in PADDING_TYPES]
    for i in range(4):
        for j in range(i):
            assert (outs[i] - outs[j]).abs().max() > 1e-4


@pytest.mark.parametrize("kw", [tp.HIRE, NORM], ids=["small", "patcher_norm"])
def test_same_seed_same_weights(kw):
    got = tp.check_same_seed(jm.HireMLP, jt.HireMLP, kw)
    assert got["layers.1.model.2.0.fn.0.proj_h.net.0.weight"].shape == (16, 96, 1, 1)
    assert "layers.1.patch_merge.1.reduction.0.weight" in got  # held, never run
    assert ("patcher.reduction.1.1.weight" in got) == kw.get("patcher_norm", False)


@pytest.mark.parametrize("kw", [tp.HIRE, NORM], ids=["small", "patcher_norm"])
def test_state_dict_from_jax_equals_export(kw):
    tp.check_convert("hire_mlp", jm.HireMLP, jt.HireMLP, kw)


def test_state_dict_from_jax_needs_a_template_for_the_unused_merge():
    import jax

    params = jax.tree.map(np.asarray, jm.HireMLP(**tp.HIRE).params)
    with pytest.raises(ValueError, match="patch_merge"):
        state_dict_from_jax("hire_mlp", params)
    port = jt.HireMLP(**tp.HIRE, **tp.CPU)
    sd = state_dict_from_jax("hire_mlp", params, template=port.state_dict())
    port.load_state_dict(sd, strict=True)


def test_f32_logits_match_jax_with_patcher_norm():
    tp.check_port_parity(jm.HireMLP, jt.HireMLP, NORM, (2, 3, 32, 32), name="hire_mlp")


def test_bf16_logits_within_band_of_jax_f32():
    tp.check_bf16(jm.HireMLP, jt.HireMLP, tp.HIRE, (8, 3, 32, 32))


def test_int8_logits_within_band_of_jax_int8_mode():
    tp.check_int8(jm.HireMLP, jt.HireMLP, tp.HIRE, (8, 3, 32, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    q = tp.check_int8_state_dict("hire_mlp", jm.HireMLP, jt.HireMLP, tp.HIRE, dtype)
    # stage 0's merge (32, 16, 3, 3) is an int8 leaf; the last one, as
    # large, is not in the JAX params and stays float
    assert isinstance(q["layers.0.patch_merge.1.reduction.0.weight"], dict)
    assert not isinstance(q["layers.1.patch_merge.1.reduction.0.weight"], dict)
    # the stacked bottleneck (3, 16, 96, 1, 1): a scale a (block, out-channel)
    assert q["layers.1.model.0.0.fn.0.proj_h.net.0.weight"]["scale"].shape == (16, 1, 1, 1)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.HireMLP, tp.HIRE, 32, opts)


@PADS
@pytest.mark.parametrize("n,p", [(5, 3), (4, 4), (3, 8), (1, 2)])
def test_pad_end_equals_numpy_pad(padding_type, n, p):
    x = np.random.default_rng(0).standard_normal((2, n, 3, 2)).astype(np.float32)
    mode = {"circular": "wrap", "replicate": "edge"}.get(padding_type, padding_type)
    want = np.pad(x, ((0, 0), (0, p), (0, 0), (0, 0)), mode=mode)
    np.testing.assert_array_equal(_pad_end(torch.from_numpy(x), 1, p, padding_type).numpy(),
                                  want)


def test_factory_options():
    tp.check_factory_device(jt.HireMLP, tp.HIRE)
    m = jt.HireMLP(**tp.HIRE, **tp.CPU)
    assert m.name == "hire_mlp"
    assert [blk.step for blk in m.layers[1].model] == [0, 1, 0]  # (j + 1) % 2 == 0
    with pytest.raises(ValueError, match="padding_type"):
        jt.HireMLP(**tp.HIRE, padding_type="mirror", **tp.CPU)
