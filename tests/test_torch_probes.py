"""Probes and FLOPs of the port against jittor_mlp_tpu's, on the CPU.

- ``utils.probes.capture`` on a small AS-MLP: the same tags in the same
  order as the JAX ``capture``, each value (NHWC) and the logits within
  1e-4 on the same weights; ``nnf.probe`` is the identity without a sink;
  a forward on another thread records nothing into a capture; the train
  mode and the model's mode around it.
- ``Model.flops``: the Mixer's count is the analytic Σ 2·M·N·K exactly, and
  0.6–1.0 of the JAX ``flops()`` (XLA's cost analysis, which also counts
  elementwise work) at two configurations; the block ops' flop formulas
  give the bf16 forward (through the ops) the f32 forward's count; all 23
  small configurations give a finite, positive, repeatable count.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_deploy_zoo import ZOO

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.utils.probes import capture as jax_capture
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.utils.probes import capture

AS = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2, 2],
          shift_size=3)
TAGS = ["patch_embed", "stage0", "stage1", "stage2"]


def _images(n=2, side=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3, side, side)).astype(np.float32)


def test_capture_matches_jax_capture():
    jmodel = jm.AS_MLP(**AS)
    model = jt.AS_MLP(**AS, seed=1, device="cpu")
    model.load_torch_state_dict(jmodel.export_torch_state_dict(tensors=False))
    x = _images()
    with jconfig.parity_mode():
        jout, jprobes = jax_capture(jmodel.apply, jmodel.params, jnp.asarray(x))
    with config.parity_mode():
        out, probes = capture(model, x)
    assert [t for t, _ in probes] == [t for t, _ in jprobes] == TAGS
    for (tag, v), (_, w) in zip(probes, jprobes):
        assert v.device == model.device and v.shape == w.shape, tag
        np.testing.assert_allclose(v.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=tag)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-4)
    assert probes[1][1].shape == (2, 4, 4, 32)  # NHWC, after stage 0's patch merging


def test_probe_is_the_identity_without_a_sink_and_capture_keeps_the_mode():
    x = torch.randn(3, 4)
    assert nnf.probe("t", x) is x
    with nnf.probe_sink() as sink:
        assert nnf.probe("t", x) is x
    assert sink == [("t", x)]
    model = jt.AS_MLP(**AS, drop_path_rate=0.5, device="cpu").eval()
    x = _images()
    out_eval, _ = capture(model, x)
    out_a, _ = capture(model, x, train=True, generator=torch.Generator().manual_seed(0))
    out_b, probes = capture(model, x, train=True, generator=torch.Generator().manual_seed(0))
    assert not model.training
    assert torch.equal(out_a, out_b) and not torch.equal(out_a, out_eval)
    assert [t for t, _ in probes] == TAGS and not out_a.requires_grad


def test_no_capture_across_threads():
    """Forwards on another thread, with no sink of their own, while this
    thread captures: the capture holds its own four tags once each."""
    model = jt.AS_MLP(**AS, device="cpu").eval()
    x = torch.from_numpy(_images())
    stop = threading.Event()
    ran = []

    def other():
        with torch.no_grad():
            while not stop.is_set():
                model.forward(x)
                ran.append(1)

    t = threading.Thread(target=other)
    t.start()
    try:
        for _ in range(5):
            _, probes = capture(model, x)
            assert [tag for tag, _ in probes] == TAGS
    finally:
        stop.set()
        t.join(timeout=60)
    assert ran


def test_mixer_flops_are_the_products_and_near_jax():
    kw = dict(d_model=32, depth=1, patch_size=8, image_size=16, num_classes=10)
    model = jt.MLPMixerForImageClassification(**kw, device="cpu")
    B, N, D, TD, CD = 2, 4, 32, 16, 128  # token_dim = N·4, channel hidden D·4
    want = (2 * B * N * 3 * 64 * D  # patch embed: N patches of 3·8·8
            + kw["depth"] * 4 * B * N * D * (TD + CD) + 2 * B * D * 10)
    assert model.flops((B, 3, 16, 16)) == want
    for kw, want_port in ((dict(d_model=32, depth=1, patch_size=8, image_size=16,
                                num_classes=4), 123136),
                          (dict(d_model=64, depth=2, patch_size=4, image_size=32,
                                num_classes=10), 17171712)):
        shape = (1, 3, kw["image_size"], kw["image_size"])
        got = jt.MLPMixerForImageClassification(**kw, device="cpu").flops(shape)
        ref = jm.MLPMixerForImageClassification(**kw).flops(shape)
        assert got == want_port and 0.6 * ref <= got <= ref, (got, ref)


@pytest.mark.parametrize("name", ["mlp_mixer", "res_mlp", "g_mlp", "as_mlp"])
def test_block_ops_count_the_plain_blocks_products(name):
    factory, kw, hw, _ = ZOO[name]
    model = factory(**kw, device="cpu")
    f32 = model.flops((2, 3, hw, hw))
    assert f32 == model.flops((2, 3, hw, hw)) > 0
    model.to_bf16()
    assert model.flops((2, 3, hw, hw)) == f32


@pytest.mark.parametrize("name", list(ZOO))
def test_every_family_counts_flops(name):
    factory, kw, hw, settings = ZOO[name]
    with settings():
        model = factory(**kw, device="cpu").train()
    count = model.flops((1, 3, hw, hw))
    assert np.isfinite(count) and count > 0 and isinstance(count, float)
    assert model.flops((1, 3, hw, hw)) == count and model.training
