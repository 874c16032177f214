"""The port's GFNet and GFNetPyramid against jittor_mlp_tpu's, on the CPU
(tests/torch_parity.py).

Configurations: tools/parity_report.py's GFNet (img 32, patch 8, embed 32,
depth 3: a 4 × 4 grid) and GFNetPyramid (img 32, patch 4, embed
[16, 32, 48, 64], depths [1, 1, 2, 1]: grids 8, 4, 2, 1), and odd grids: a
GFNet at img 28, patch 4 (7 × 7, whose rfft2 has 4 columns and whose
irfft2 needs the size to give 7 back) and a GFNetPyramid at img 96 (grids
24, 12, 6, 3). Per family: the same seed gives the same weights; the JAX
params (blocks stacked as ``blocks`` or ``blocks.{s}``) convert to the
port's state dict; float32 logits within 1e-4 of the JAX forward; bf16
and int8_mode() within their bands; the weights="int8" state dict
bit-equal to JAX's, the stacked (L, a, b, C, 2) ``complex_weight`` with
one scale per (block, grid row); Predictor batched == alone. GFNet's
``representation_size`` (pre_logits) and GFNetPyramid's
``no_layerscale``. ``global_filter`` (rfft2 · weight · irfft2 in float32)
against the JAX DFT-product filter at grids 3, 7 and 14 within 1e-5, and
in bf16 run in float32 and rounded once. At img 56 (grids 14, 7, 3, 1)
the 7 → 3 downsample fails in the JAX forward; the port refuses the size
when it builds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.models import gfnet as jgfnet
from jittor_mlp_tpu_torch.models import gfnet as tgfnet

GF = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32, depth=3)
GF7 = dict(img_size=28, patch_size=4, num_classes=10, embed_dim=16, depth=2)
PYR = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=[16, 32, 48, 64],
           depth=[1, 1, 2, 1])
PYR96 = dict(img_size=96, patch_size=4, num_classes=10, embed_dim=[8, 16, 16, 24],
             depth=[1, 1, 1, 1])
# (name, JAX factory, port factory, kwargs, image size)
CASES = {
    "gfnet": ("gfnet", jm.GFNet, jt.GFNet, GF, 32),
    "gfnet_grid7": ("gfnet", jm.GFNet, jt.GFNet, GF7, 28),
    "pyramid": ("gfnet_pyramid", jm.GFNetPyramid, jt.GFNetPyramid, PYR, 32),
    "pyramid_img96": ("gfnet_pyramid", jm.GFNetPyramid, jt.GFNetPyramid, PYR96, 96),
}
IDS = list(CASES)


@pytest.mark.parametrize("case", IDS)
def test_same_seed_same_weights(case):
    _, jf, tf, kw, _ = CASES[case]
    got = tp.check_same_seed(jf, tf, kw)
    cw = got["blocks.0.filter.complex_weight" if jf is jm.GFNet
             else "blocks.3.0.filter.complex_weight"]
    grid = {"gfnet": 4, "gfnet_grid7": 7, "pyramid": 1, "pyramid_img96": 3}[case]
    assert cw.shape[:2] == (grid, grid // 2 + 1)


@pytest.mark.parametrize("case", IDS)
def test_state_dict_from_jax_equals_export(case):
    name, jf, tf, kw, _ = CASES[case]
    tp.check_convert(name, jf, tf, kw)


@pytest.mark.parametrize("case", IDS)
def test_f32_logits_match_jax(case):
    name, jf, tf, kw, hw = CASES[case]
    tp.check_port_parity(jf, tf, kw, (2, 3, hw, hw), name=case)


@pytest.mark.parametrize("case", ["gfnet", "pyramid"])
def test_bf16_logits_within_band_of_jax_f32(case):
    _, jf, tf, kw, hw = CASES[case]
    tp.check_bf16(jf, tf, kw, (8, 3, hw, hw))


@pytest.mark.parametrize("case", ["gfnet", "pyramid"])
def test_int8_logits_within_band_of_jax_int8_mode(case):
    _, jf, tf, kw, hw = CASES[case]
    tp.check_int8(jf, tf, kw, (8, 3, hw, hw))


@pytest.mark.parametrize("case", ["gfnet", "pyramid_img96"])
def test_int8_state_dict_equals_jax_dequantize_tree(case):
    name, jf, tf, kw, _ = CASES[case]
    q = tp.check_int8_state_dict(name, jf, tf, kw)
    key = "blocks.1.filter.complex_weight" if name == "gfnet" else \
        "blocks.0.0.filter.complex_weight"
    cw = q[key]
    assert isinstance(cw, dict) and cw["q"].dtype == torch.int8
    grid = 4 if name == "gfnet" else 24
    assert cw["scale"].shape == (grid, 1, 1, 1)  # this block's slice of (L, a, 1, 1, 1)
    if name == "gfnet":  # one scale per (block, grid row)
        scales = torch.stack([q[f"blocks.{i}.filter.complex_weight"]["scale"]
                              for i in range(GF["depth"])])
        assert len(torch.unique(scales)) == GF["depth"] * grid


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
@pytest.mark.parametrize("case", ["gfnet", "pyramid"])
def test_predictor_batched_equals_alone(case, opts):
    _, _, tf, kw, hw = CASES[case]
    tp.check_predictor(tf, kw, hw, opts)


@pytest.mark.parametrize("case", ["gfnet", "pyramid"])
def test_factory_options(case):
    name, _, tf, kw, _ = CASES[case]
    tp.check_factory_device(tf, kw)
    assert tf(**kw, **tp.CPU).name == name


def test_representation_size_pre_logits():
    kw = {**GF, "representation_size": 24}
    got = tp.check_same_seed(jm.GFNet, jt.GFNet, kw)
    assert got["pre_logits.fc.weight"].shape == (24, 32) and got["head.weight"].shape == (10, 24)
    tp.check_convert("gfnet", jm.GFNet, jt.GFNet, kw)
    tp.check_port_parity(jm.GFNet, jt.GFNet, kw, (2, 3, 32, 32), name="pre_logits")
    tp.check_int8(jm.GFNet, jt.GFNet, kw, (8, 3, 32, 32))


def test_no_layerscale():
    kw = {**PYR, "no_layerscale": True}
    got = tp.check_same_seed(jm.GFNetPyramid, jt.GFNetPyramid, kw)
    assert not any(k.endswith(".gamma") for k in got)
    tp.check_convert("gfnet_pyramid", jm.GFNetPyramid, jt.GFNetPyramid, kw)
    tp.check_port_parity(jm.GFNetPyramid, jt.GFNetPyramid, kw, (2, 3, 32, 32),
                         name="no_layerscale")


def test_init_values_reach_gamma():
    got = jt.GFNetPyramid(**PYR, init_values=1e-6, **tp.CPU).state_dict()
    assert torch.equal(got["blocks.2.1.gamma"], torch.full((48,), 1e-6))


def _filter_inputs(a, C, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, a * a, C)).astype(np.float32)
    w = (r.standard_normal((a, a // 2 + 1, C, 2)) * 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("a", [3, 7, 14])
def test_global_filter_matches_jax_dft_products(a):
    x, w = _filter_inputs(a, 6, a)
    with jconfig.parity_mode():
        want = np.asarray(jgfnet.global_filter({"complex_weight": jnp.asarray(w)},
                                               jnp.asarray(x), a, a))
    got = tgfnet.global_filter(torch.from_numpy(x), torch.from_numpy(w), a, a)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_global_filter_bf16_runs_in_float32():
    """torch.fft takes no bf16: the bf16 filter is the float32 one on the
    same bf16 values, rounded once."""
    x, w = _filter_inputs(7, 8, 1)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = tgfnet.global_filter(xb, wb, 7, 7)
    want = tgfnet.global_filter(xb.float(), wb.float(), 7, 7).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_odd_downsample_refused():
    """img 56: grids 14, 7, 3, 1; the JAX forward fails on the 7 → 3 patch
    reshape, the port at build."""
    kw = {**PYR, "img_size": 56}
    with pytest.raises(TypeError, match="reshape"):
        jm.GFNetPyramid(**kw)(tp.images((1, 3, 56, 56)))
    with pytest.raises(ValueError, match=r"\[14, 7, 3, 1\]"):
        jt.GFNetPyramid(**kw, **tp.CPU)
