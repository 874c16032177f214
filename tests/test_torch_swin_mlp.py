"""The port's SwinMLP against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

At the small configuration of tools/parity_report.py (img 32, embed 16,
depths [2, 2], heads [2, 4], window 4: stage 0 shifts, stage 1's window
is clamped to its 4 × 4 resolution and does not shift), at
tests/test_swin_mlp.py's ``ape`` case with a third stage whose 2 × 2
resolution clamps the window to 2, and at a window of 7 with three heads
(Swin-MLP-T's stage-0 window and heads; its per-block spatial weight
(147, 49, 1) is an int8 leaf of its own): the same seed gives the same
weights; the JAX params convert to the port's state dict; float32 logits
within 1e-4; bf16 and int8_mode() within their bands; weights="int8"
bit-equal to JAX's; Predictor's batched answers equal single ones;
``use_checkpoint`` gives the same gradients. ``window_partition`` and
``window_reverse`` equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.ops import window as jwindow
from jittor_mlp_tpu_torch.ops import window as twindow

APE = {**tp.SWIN, "depths": [2, 2, 2], "num_heads": [2, 4, 8], "ape": True}
WS7 = dict(img_size=56, patch_size=4, num_classes=10, embed_dim=24, depths=[2, 2],
           num_heads=[3, 6], window_size=7, drop_path_rate=0.0)
CONFIGS = pytest.mark.parametrize("kw,size", [(tp.SWIN, 32), (APE, 32), (WS7, 56)],
                                  ids=["small", "ape_small_window", "window7"])


@CONFIGS
def test_same_seed_same_weights(kw, size):
    got = tp.check_same_seed(jm.SwinMLP, jt.SwinMLP, kw)
    assert ("absolute_pos_embed" in got) == kw.get("ape", False)
    if kw is APE:  # stage 2 at 2 × 2: the window clamped to 2
        assert got["layers.2.blocks.1.spatial_mlp.weight"].shape == (8 * 4, 4, 1)


@CONFIGS
def test_state_dict_from_jax_equals_export(kw, size):
    tp.check_convert("swin_mlp", jm.SwinMLP, jt.SwinMLP, kw)


@CONFIGS
def test_f32_logits_match_jax(kw, size):
    tp.check_port_parity(jm.SwinMLP, jt.SwinMLP, kw, (2, 3, size, size), name="swin_mlp")


@CONFIGS
def test_bf16_logits_within_band_of_jax_f32(kw, size):
    tp.check_bf16(jm.SwinMLP, jt.SwinMLP, kw, (8, 3, size, size))


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw, size):
    tp.check_int8(jm.SwinMLP, jt.SwinMLP, kw, (8, 3, size, size))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    q = tp.check_int8_state_dict("swin_mlp", jm.SwinMLP, jt.SwinMLP, WS7, dtype)
    sp = q["layers.0.blocks.1.spatial_mlp.weight"]  # (147, 49, 1): a scale a row
    assert isinstance(sp, dict) and sp["scale"].shape == (147, 1, 1)
    assert not isinstance(q["layers.0.blocks.1.norm1.weight"], dict)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.SwinMLP, APE, 32, opts)


def test_window_partition_and_reverse_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)
    want = np.asarray(jwindow.window_partition(jnp.asarray(x), 4))
    win = twindow.window_partition(torch.from_numpy(x), 4)
    assert win.shape == (12, 4, 4, 5)
    np.testing.assert_array_equal(win.numpy(), want)
    back = twindow.window_reverse(win, 4, 8, 12)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jwindow.window_reverse(jnp.asarray(want), 4, 8, 12)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_use_checkpoint_gives_the_same_gradients():
    x = torch.from_numpy(tp.images((2, 3, 32, 32)))
    grads = []
    for ckpt in (False, True):
        model = jt.SwinMLP(**tp.SWIN, use_checkpoint=ckpt, **tp.CPU)
        model(x).square().mean().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_factory_options():
    tp.check_factory_device(jt.SwinMLP, tp.SWIN)
    tp.check_block_runner(jt.SwinMLP, tp.SWIN, 32, stacks=2)  # applied, unlike JAX's
    m = jt.SwinMLP(**tp.SWIN, drop_rate=0.5, patch_norm=False, **tp.CPU)
    assert m.name == "swin_mlp" and m.patch_embed.norm is None
    shifts = [[blk.shift_size for blk in layer.blocks] for layer in m.layers]
    assert shifts == [[0, 2], [0, 0]]  # stage 1: min(res) 4 = window, no shift
    t = jt.SwinMLP(device="meta")  # Swin-MLP-T: windows 7 and a 7 × 7 last stage
    assert [[blk.shift_size for blk in layer.blocks][-1] for layer in t.layers] == [3, 3, 3, 0]
    assert t.layers[2].blocks[5].spatial_mlp.weight.shape == (12 * 49, 49, 1)
