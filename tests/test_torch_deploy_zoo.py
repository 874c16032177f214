"""Every family of the port through ``deploy`` on the CPU, at the small sizes
of ``torch_parity``: ``save_exported`` → ``load_exported`` gives the eager
float32 eval forward bit for bit, and a batch of another size raises.
(The BatchNorm families run with the seed's running statistics: the
program must reproduce whatever the eager forward computes.)"""

import contextlib

import numpy as np
import pytest
import torch

import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu_torch import deploy
from jittor_mlp_tpu_torch.models import active_mlp, conv_mlp, cycle_mlp, repmlpnet, s2_mlp_v1

NULL = contextlib.nullcontext
# name: (factory, kwargs, image side, settings context)
ZOO = {
    "mlp_mixer": (jt.MLPMixerForImageClassification,
                  dict(image_size=32, patch_size=8, d_model=32, depth=2, num_classes=10), 32, NULL),
    "res_mlp": (jt.ResMLPForImageClassification,
                dict(d_model=32, num_classes=10, patch_size=8, image_size=32, depth=2), 32, NULL),
    "g_mlp": (jt.gMLPForImageClassification,
              dict(d_model=32, d_ffn=64, num_classes=10, patch_size=8, image_size=32, depth=2),
              32, NULL),
    "as_mlp": (jt.AS_MLP, dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                               depths=[2, 2], shift_size=3), 32, NULL),
    "vip": (jt.ViP, tp.VIP, 32, NULL),
    "s2_mlp_v1": (s2_mlp_v1.S2MLPv1, tp.S2, 32, NULL),
    "s2_mlp_v2": (jt.S2MLPv2, tp.S2, 32, NULL),
    "raft_mlp": (jt.RaftMLP, tp.RAFT, 16, NULL),
    "swin_mlp": (jt.SwinMLP, tp.SWIN, 32, NULL),
    "dyna_mlp": (jt.DynaMixer, tp.DYNA, 32, tp.dyna_xs),
    "ms_mlp": (jt.MS_MLP, tp.MS, 32, NULL),
    "hire_mlp": (jt.HireMLP, tp.HIRE, 32, NULL),
    "cycle_mlp": (cycle_mlp.CycleNet, tp.CYCLE, 32, NULL),
    "active_mlp": (active_mlp.ActiveMLP, tp.ACTIVE, 32, NULL),
    "conv_mixer": (jt.ConvMixer, tp.CONV_MIXER, 32, NULL),
    "sparse_mlp": (jt.SparseMLP, tp.SPARSE, 32, NULL),
    "morph_mlp": (jt.MorphMLP, tp.MORPH, 32, tp.morph_xs),
    "wave_mlp": (jt.WaveMLP, tp.WAVE, 64, tp.wave_xs),
    "conv_mlp": (conv_mlp.ConvMLP, tp.CONV_MLP, 64, NULL),
    "repmlpnet": (repmlpnet.RepMLPNet, tp.REPMLP, 16, NULL),
    "gfnet": (jt.GFNet, dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32, depth=2),
              32, NULL),
    "gfnet_pyramid": (jt.GFNetPyramid, dict(img_size=32, patch_size=4, num_classes=10,
                                            embed_dim=[16, 32, 48, 64], depth=[1, 1, 1, 1]),
                      32, NULL),
    "sequencer": (jt.Sequencer2D, tp.SEQ, 28, tp.sequencer_xs),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_family_round_trips_through_export(name, tmp_path):
    factory, kw, hw, settings = ZOO[name]
    with settings():
        model = factory(**kw, **tp.CPU).eval()
    assert model.name == name
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, hw, hw)).astype(
        np.float32))
    with torch.inference_mode():
        want = model.forward(x)
    path = deploy.save_exported(model, str(tmp_path / f"{name}.pt2"), batch_size=2,
                                image_size=hw)
    fwd = deploy.load_exported(path)
    assert torch.equal(fwd(x), want)
    with pytest.raises(Exception):
        fwd(x[:1])
