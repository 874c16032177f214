"""The port's RepMLPNet against jittor_mlp_tpu's, on the CPU (tests/torch_parity.py).

Two small configurations: tools/parity_report.py's (img 16, patch 2,
channels (8, 16), tiles (4, 2) on maps 8 and 4: each map split into 2 × 2
tiles, sharesets (2, 4), conv branches k = 1 and 3) and a whole-map one
(tiles (8, 4), the maps themselves: the JAX package then runs its
``_conv_bn_tiled`` lowering, whose BatchNorm statistics are pooled over the
C/S replicas). In each, training form and deploy form: the same seed gives
the same weights; the JAX params convert to the port's state dict and load
strictly. With the running statistics of the JAX ``recalibrate_bn``:
float32 logits within 1e-4, bf16 and int8_mode() within their bands (a
near tie may flip in bf16, see ``check_bf16``), weights="int8" bit-equal to
JAX's, Predictor's batched answers equal single ones. The port's
``recalibrate_bn`` gives JAX's running statistics within 1e-5 at every
site, the grouped ``fc3_bn`` and ``repconv{k}.bn`` included; the
train-mode forward equals JAX's within 1e-4 and changes no buffer.
``locality_injection()`` equals the JAX ``inject_locality`` on the same
parameters, keeps the logits within 1e-4, and leaves the deploy form,
whose state dict loads strictly into ``deploy=True`` in both packages.
"""

import jax
import numpy as np
import pytest
import torch
from conftest import assert_close

import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.core.train_utils import recalibrate_bn as j_recalibrate_bn
from jittor_mlp_tpu.models import repmlpnet as jrep
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.core.train_utils import recalibrate_bn
from jittor_mlp_tpu_torch.models import repmlpnet as trep

WHOLE = {**tp.REPMLP, "hs": (8, 4), "ws": (8, 4)}
CONFIGS = pytest.mark.parametrize("kw", [tp.REPMLP, WHOLE], ids=["tiles", "whole_map"])
FORMS = pytest.mark.parametrize("deploy", [False, True], ids=["train_form", "deploy"])
SHAPE = (4, 3, 16, 16)
CALIBRATED = tp.calibrated(jrep.RepMLPNet, trep.RepMLPNet, SHAPE)


@CONFIGS
@FORMS
def test_same_seed_same_weights(kw, deploy):
    got = tp.check_same_seed(jrep.RepMLPNet, trep.RepMLPNet, {**kw, "deploy": deploy})
    assert ("stages.1.1.repmlp_block.fc3.bias" in got) == deploy
    assert ("stages.1.1.repmlp_block.repconv3.bn.running_var" in got) == (not deploy)
    assert got["stages.1.0.repmlp_block.fc3.weight"].shape == (4 * kw["hs"][1] ** 2,
                                                               kw["hs"][1] ** 2, 1, 1)


@CONFIGS
@FORMS
def test_state_dict_from_jax_equals_export(kw, deploy):
    tp.check_convert("repmlpnet", jrep.RepMLPNet, trep.RepMLPNet, {**kw, "deploy": deploy})


@CONFIGS
def test_f32_logits_match_jax_with_recalibrated_statistics(kw):
    tp.check_port_parity(*CALIBRATED, kw, (2, 3, 16, 16), name="repmlpnet")


@CONFIGS
def test_bf16_logits_within_band_of_jax_f32(kw):
    tp.check_bf16(*CALIBRATED, kw, (8, 3, 16, 16), exempt_ties=True)


@CONFIGS
def test_int8_logits_within_band_of_jax_int8_mode(kw):
    tp.check_int8(*CALIBRATED, kw, (8, 3, 16, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(dtype):
    q = tp.check_int8_state_dict("repmlpnet", *CALIBRATED, tp.REPMLP, dtype)
    # stage 1's stacked ffn_fc1 (2, 64, 16, 1, 1): a scale a (block, out-channel)
    assert q["stages.1.0.ffn_block.ffn_fc1.conv.weight"]["scale"].shape == (64, 1, 1, 1)
    assert not isinstance(q["stages.1.0.repmlp_block.fc3.weight"], dict)  # 128 weights


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(CALIBRATED[1], tp.REPMLP, 16, opts)


@CONFIGS
def test_recalibrate_bn_equals_jax_at_every_site(kw):
    batches = [tp.images(SHAPE, seed=30 + i) for i in range(3)]
    jmodel = j_recalibrate_bn(jrep.RepMLPNet(**kw), batches)
    port = recalibrate_bn(jt.models.repmlpnet.RepMLPNet(**kw, **tp.CPU), batches)
    want = jmodel.export_torch_state_dict(tensors=False)
    got = port.export_torch_state_dict(tensors=False)
    sites = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert "stages.0.0.repmlp_block.fc3_bn.running_var" in sites
    assert "stages.1.1.repmlp_block.repconv1.bn.running_mean" in sites
    for k in sites:
        assert_close(got[k], want[k], tol=1e-5, name=k)
    x = tp.images((2, 3, 16, 16), seed=3)
    with jconfig.parity_mode():
        jlogits = np.asarray(jmodel(x))
    with config.parity_mode(), torch.inference_mode():
        assert_close(port.eval()(x).numpy(), jlogits, tol=1e-4, name="recalibrated")


@CONFIGS
def test_train_forward_equals_jax_and_changes_no_buffer(kw):
    x = tp.images(SHAPE, seed=5)
    with jconfig.parity_mode():
        want = np.asarray(jrep.RepMLPNet(**kw).train()(x))
    port = trep.RepMLPNet(**kw, **tp.CPU).train()
    before = {k: v.clone() for k, v in port.named_buffers()}
    with config.parity_mode(), torch.no_grad():
        got = port(x).numpy()
    assert_close(got, want, tol=1e-4, name="train forward")
    for k, v in port.named_buffers():
        assert torch.equal(v, before[k]), k


@CONFIGS
def test_locality_injection_equals_jax_inject_locality(kw):
    jmodel = CALIBRATED[0](**kw).locality_injection()
    want = state_dict_from_jax("repmlpnet", jax.tree.map(np.asarray, jmodel.params))
    port = CALIBRATED[1](**kw, **tp.CPU).eval()
    x = tp.images((2, 3, 16, 16), seed=6)
    with config.parity_mode(), torch.inference_mode():
        unfolded = port(x).numpy()
    assert port.locality_injection() is port and port.deploy
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    assert not any("fc3_bn" in k or "repconv" in k for k in got)
    for k in want:
        assert_close(got[k].numpy(), want[k].numpy(), tol=1e-6, name=k)
    with config.parity_mode(), torch.inference_mode():
        folded = port(x).numpy()
    assert_close(folded, unfolded, tol=1e-4, name="folded vs unfolded")
    with jconfig.parity_mode():
        assert_close(folded, np.asarray(jmodel(x)), tol=1e-4, name="folded vs JAX folded")


@CONFIGS
def test_deploy_state_dict_loads_strictly_into_deploy_form(kw):
    port = CALIBRATED[1](**kw, **tp.CPU).eval().locality_injection()
    sd = port.export_torch_state_dict()
    deploy = trep.RepMLPNet(**kw, deploy=True, seed=7, **tp.CPU).eval()
    assert deploy.deploy
    deploy.load_state_dict(sd, strict=True)
    jdeploy = jrep.RepMLPNet(**kw, deploy=True).load_torch_state_dict(sd)
    x = tp.images((2, 3, 16, 16), seed=8)
    with config.parity_mode(), torch.inference_mode():
        got = deploy(x).numpy()
        np.testing.assert_array_equal(got, port(x).numpy())
    with jconfig.parity_mode():
        assert_close(got, np.asarray(jdeploy(x)), tol=1e-4, name="deploy vs JAX deploy")
    assert port.locality_injection().deploy  # folding a deploy model is a no-op
    with pytest.raises(RuntimeError, match="fc3_bn"):
        trep.RepMLPNet(**kw, **tp.CPU).load_state_dict(sd, strict=True)


def test_factories_and_device():
    tp.check_factory_device(trep.RepMLPNet, tp.REPMLP)
    for factory, jfactory in ((jt.create_RepMLPNet_B224, jrep.create_RepMLPNet_B224),
                              (jt.create_RepMLPNet_B256, jrep.create_RepMLPNet_B256)):
        port = factory(deploy=True, num_class=10, **tp.CPU)
        assert port.name == "repmlpnet" and port.deploy
        want = jfactory(deploy=True, num_class=10)._init_sd
        got = port.state_dict()
        assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
