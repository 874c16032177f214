"""The port's MS-MLP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small configuration of tools/parity_report.py (img 32, embed 16,
depths [2, 2], shift 3 with distances [-1, 0, 1], kernels [[1, 3, 5],
[1, 3, 3]]: chunks of 6, 6 and 4 channels, then 11, 11 and 10), with the
gamma layer scale raised to 0.5 so that the blocks move the logits, and at
an embed width of 10 (chunks of 4, 4 and 2): the same seed gives the same
weights; the JAX params convert to the port's state dict; float32 logits
within 1e-4; bf16 and int8_mode() within their bands; weights="int8"
bit-equal to JAX's, also at MS-MLP-T's full width, where the stacked
depthwise kernels are int8 leaves; Predictor's batched answers equal
single ones; ``_chunk_sizes`` sizes as torch.chunk.
"""

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.models.ms_mlp import _chunk_sizes as j_chunk_sizes
from jittor_mlp_tpu_torch.models.ms_mlp import _chunk_sizes

NARROW = {**tp.MS, "embed_dim": 10}
CONFIGS = pytest.mark.parametrize("kw", [tp.MS, NARROW], ids=["small", "embed10"])


def _scaled_gamma(factory):
    """The factory, with every block's gamma raised from 1e-6 to 0.5 (in
    both packages, through the torch state dict): at 1e-6 the blocks add
    next to nothing and the parity would not see them."""
    def build(**kw):
        m = factory(**kw)
        sd = m.export_torch_state_dict()
        sd = {k: (torch.full_like(v, 0.5) if k.endswith(".gamma") else v) for k, v in sd.items()}
        return m.load_torch_state_dict(sd)
    return build


@CONFIGS
def test_same_seed_same_weights(kw):
    got = tp.check_same_seed(jm.MS_MLP, jt.MS_MLP, kw)
    assert got["layers.0.blocks.1.dwconv_lr.2.weight"].shape == (
        (4, 1, 5, 5) if kw is tp.MS else (2, 1, 5, 5))
    assert got["layers.1.blocks.0.gamma"].shape == (2 * kw["embed_dim"],)


@CONFIGS
def test_state_dict_from_jax_equals_export(kw):
    tp.check_convert("ms_mlp", jm.MS_MLP, jt.MS_MLP, kw)


@CONFIGS
def test_f32_logits_match_jax(kw):
    tp.check_port_parity(_scaled_gamma(jm.MS_MLP), jt.MS_MLP, kw, (2, 3, 32, 32),
                         name="ms_mlp")


def test_blocks_move_the_logits_at_raised_gamma():
    """With gamma 0.5 the blocks are not the identity: the logits move
    against gamma 0, so the parity above sees them."""
    m = _scaled_gamma(jt.MS_MLP)(**tp.MS, **tp.CPU).eval()
    x = tp.images((2, 3, 32, 32))
    with torch.inference_mode():
        a = m(x)
        for blk in (b for layer in m.layers for b in layer.blocks):
            blk.gamma.zero_()
        b = m(x)
    assert (a - b).abs().max() > 0.1 * a.abs().max()


@CONFIGS
def test_bf16_logits_within_band_of_jax_f32(kw):
    tp.check_bf16(_scaled_gamma(jm.MS_MLP), _scaled_gamma(jt.MS_MLP), kw, (8, 3, 32, 32))


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw):
    tp.check_int8(_scaled_gamma(jm.MS_MLP), _scaled_gamma(jt.MS_MLP), kw, (8, 3, 32, 32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    tp.check_int8_state_dict("ms_mlp", jm.MS_MLP, jt.MS_MLP, tp.MS, dtype)


def test_int8_state_dict_full_width_quantizes_the_depthwise_stacks():
    """MS-MLP-T: stage 2's six blocks stack each chunk's depthwise kernel
    (6, 76, 1, 3, 3) into an int8 leaf, a scale a (block, channel)."""
    kw = dict(num_classes=10, drop_path_rate=0.0)
    q = tp.check_int8_state_dict("ms_mlp", jm.MS_MLP, jt.MS_MLP, kw)
    dw = q["layers.2.blocks.3.dwconv_td.4.weight"]
    assert isinstance(dw, dict) and dw["scale"].shape == (76, 1, 1, 1)
    assert not isinstance(q["layers.0.blocks.0.dwconv_lr.4.weight"], dict)  # 2 × 20 × 49


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.MS_MLP, tp.MS, 32, opts)


@pytest.mark.parametrize("dim,n", [(96, 5), (768, 5), (16, 3), (10, 3), (4, 3), (7, 7)])
def test_chunk_sizes_as_torch_chunk(dim, n):
    want = [t.shape[-1] for t in torch.chunk(torch.zeros(dim), n)]
    assert _chunk_sizes(dim, n) == want == j_chunk_sizes(dim, n)


def test_factory_options():
    tp.check_factory_device(jt.MS_MLP, tp.MS)
    m = jt.MS_MLP(**tp.MS, **tp.CPU)
    assert m.name == "ms_mlp" and not m.stochastic
    # the reference's parameters (JAX's count adds its per-block drop-path rates)
    assert m.param_count() == sum(v.size for v in jm.MS_MLP(**tp.MS)._init_sd.values())
    remat = jt.MS_MLP(**tp.MS, use_checkpoint=True, **tp.CPU).eval()
    x = tp.images((2, 3, 32, 32))
    with torch.inference_mode():
        np.testing.assert_array_equal(remat(x).numpy(), m.eval()(x).numpy())
