"""The port's BatchNorm families against jittor_mlp_tpu's, on the CPU
(tests/torch_parity.py): ConvMixer, SparseMLP, MorphMLP, WaveMLP and
ConvMLP at the small configurations of tools/parity_report.py (the "XS"
MorphMLP and WaveMLP settings added to both packages). RepMLPNet has its
own file, tests/test_torch_repmlpnet.py.

For each family: the same seed gives the same weights (the port also holds
each BatchNorm's ``num_batches_tracked``, int64 0); the JAX params convert
to the port's state dict, ``num_batches_tracked`` included, and load
strictly; with the running statistics of the JAX ``recalibrate_bn`` on
seeded batches on both sides, float32 logits within 1e-4, bf16 and
int8_mode() within their bands, weights="int8" bit-equal to JAX's and
Predictor's batched answers equal single ones; the port's
``recalibrate_bn`` gives JAX's running statistics within 1e-5 at every
site and then the eval logits within 1e-4; the train-mode forward equals
JAX ``apply(train=True, rng=None)`` within 1e-4 and changes no buffer;
``make_train_step`` refuses the model. Also: weights="int8" quantizes a
ConvMixer's stacked BatchNorm leaves as JAX does (width 256, depth 8),
WaveMLP's token-fuse conv against the JAX ``_tfc`` and its channel
grouping, MorphMLP's pad and crop where the side is no multiple of the
chunk, ConvMLP without its head and its three factories.
"""

import contextlib

import numpy as np
import pytest
import torch
from conftest import assert_close

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.core.train_utils import recalibrate_bn as j_recalibrate_bn
from jittor_mlp_tpu.models import conv_mlp as jconv_mlp
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core.train_utils import recalibrate_bn
from jittor_mlp_tpu_torch.models import conv_mlp as tconv_mlp
from jittor_mlp_tpu_torch.parallel import make_train_step

FAMILIES = {  # name: (JAX factory, port factory, kwargs, image size, settings context)
    "conv_mixer": (jm.ConvMixer, jt.ConvMixer, tp.CONV_MIXER, 32, contextlib.nullcontext),
    "sparse_mlp": (jm.SparseMLP, jt.SparseMLP, tp.SPARSE, 32, contextlib.nullcontext),
    "morph_mlp": (jm.MorphMLP, jt.MorphMLP, tp.MORPH, 32, tp.morph_xs),
    "wave_mlp": (jm.WaveMLP, jt.WaveMLP, tp.WAVE, 64, tp.wave_xs),
    "conv_mlp": (jconv_mlp.ConvMLP, tconv_mlp.ConvMLP, tp.CONV_MLP, 64, contextlib.nullcontext),
}


class Family:
    def __init__(self, name):
        self.name = name
        self.jax, self.port, self.kw, self.hw, self.settings = FAMILIES[name]
        self.cjax, self.cport = tp.calibrated(self.jax, self.port, self.batch(4))

    def batch(self, n):
        return (n, 3, self.hw, self.hw)


@pytest.fixture(params=list(FAMILIES))
def fam(request):
    f = Family(request.param)
    with f.settings():
        yield f


def test_same_seed_same_weights(fam):
    got = tp.check_same_seed(fam.jax, fam.port, fam.kw)
    counters = [k for k in got if k.endswith(".num_batches_tracked")]
    assert counters and len(counters) == len([k for k in got if k.endswith(".running_var")])


def test_state_dict_from_jax_equals_export(fam):
    tp.check_convert(fam.name, fam.jax, fam.port, fam.kw)


def test_f32_logits_match_jax_with_recalibrated_statistics(fam):
    tp.check_port_parity(fam.cjax, fam.cport, fam.kw, fam.batch(2), name=fam.name)


def test_bf16_logits_within_band_of_jax_f32(fam):
    tp.check_bf16(fam.cjax, fam.cport, fam.kw, fam.batch(8))


def test_int8_logits_within_band_of_jax_int8_mode(fam):
    tp.check_int8(fam.cjax, fam.cport, fam.kw, fam.batch(8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_state_dict_equals_jax_dequantize_tree(fam, dtype):
    q = tp.check_int8_state_dict(fam.name, fam.cjax, fam.cport, fam.kw, dtype)
    counters = [k for k in q if k.endswith(".num_batches_tracked")]
    assert counters and all(q[k].dtype == torch.int64 for k in counters)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(fam, opts):
    tp.check_predictor(fam.cport, fam.kw, fam.hw, opts)


def _running_stats(sd):
    return {k: np.asarray(v, np.float32) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_recalibrate_bn_equals_jax(fam):
    batches = [tp.images(fam.batch(4), seed=30 + i) for i in range(3)]
    jmodel = j_recalibrate_bn(fam.jax(**fam.kw), batches)
    port = fam.port(**fam.kw, **tp.CPU).eval()
    assert recalibrate_bn(port, batches) is port and not port.training
    want = _running_stats(jmodel.export_torch_state_dict(tensors=False))
    got = _running_stats(port.export_torch_state_dict(tensors=False))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - (1.0 if k.endswith("var") else 0.0)).max() > 0, k  # moved
        assert_close(got[k], want[k], tol=1e-5, name=k)
    x = tp.images(fam.batch(2), seed=3)
    with jconfig.parity_mode():
        jlogits = np.asarray(jmodel(x))
    with config.parity_mode(), torch.inference_mode():
        assert_close(port(x).numpy(), jlogits, tol=1e-4, name=f"{fam.name} recalibrated")


def test_train_forward_equals_jax_and_changes_no_buffer(fam):
    x = tp.images(fam.batch(4), seed=5)
    jmodel = fam.jax(**fam.kw).train()
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    port = fam.port(**fam.kw, **tp.CPU).train()
    before = {k: v.clone() for k, v in port.named_buffers()}
    with config.parity_mode(), torch.no_grad():
        got = port(x).numpy()
    assert_close(got, want, tol=1e-4, name=f"{fam.name} train forward")
    with config.parity_mode(), torch.no_grad():
        evaluated = port.eval()(x).numpy()
    assert np.abs(evaluated - got).max() > 1e-3  # the train forward used the batch's statistics
    for k, v in port.named_buffers():
        assert torch.equal(v, before[k]), k


def test_make_train_step_refuses_a_batchnorm_model(fam):
    model = fam.port(**fam.kw, **tp.CPU)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(NotImplementedError, match="running-statistic update"):
        make_train_step(model, opt)


def test_factory_device(fam):
    tp.check_factory_device(fam.port, fam.kw)
    assert fam.port(**fam.kw, **tp.CPU).name == fam.name


def test_int8_state_dict_quantizes_stacked_batchnorm_leaves_as_jax():
    """At ConvMixer width 256, depth 8, each stacked BatchNorm leaf (8, 256)
    is an int8 leaf in JAX's ``quantize_tree``, running statistics
    included, with one scale per layer: the port holds them the same way."""
    kw = dict(dim=256, depth=8, kernel_size=3, patch_size=8, n_classes=10)
    cjax, cport = tp.calibrated(jm.ConvMixer, jt.ConvMixer, (4, 3, 32, 32))
    q = tp.check_int8_state_dict("conv_mixer", cjax, cport, kw)
    for leaf in ("running_mean", "running_var", "weight", "bias"):
        assert q[f"blocks.5.3.{leaf}"]["scale"].shape == (1,), leaf
    assert not isinstance(q["embedding.2.running_var"], dict)  # (256,): 1-D


@pytest.mark.parametrize("hw,dim", [((5, 6), 4), ((7, 3), 6)])
def test_wave_token_fuse_equals_jax_tfc(hw, dim):
    from jittor_mlp_tpu.models.wave_mlp import _tfc
    from jittor_mlp_tpu_torch.models.wave_mlp import token_fuse

    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((2, *hw, 2 * dim)).astype(np.float32)
    for kernel, padding in (((1, 7), (0, 3)), ((7, 1), (3, 0))):
        w = rng.standard_normal((dim, 2, *kernel)).astype(np.float32)
        with jconfig.parity_mode():
            want = np.asarray(_tfc({"weight": w}, x2, padding, dim))
        conv = torch.nn.Conv2d(2 * dim, dim, kernel, groups=dim, bias=False)
        conv.weight.data = torch.from_numpy(w)
        with config.parity_mode(), torch.no_grad():
            got = token_fuse(torch.from_numpy(x2), conv, padding)
        assert_close(got.numpy(), want, tol=1e-5, name=f"tfc {kernel}")


def test_wave_token_fuse_group_reads_adjacent_concat_channels():
    """Output channel g of the token-fuse conv depends on concat channels
    2g and 2g + 1 only (torch's grouping of a 2C → C conv, groups=C)."""
    from jittor_mlp_tpu_torch.models.wave_mlp import token_fuse

    dim = 4
    conv = torch.nn.Conv2d(2 * dim, dim, (1, 7), groups=dim, bias=False)
    conv.weight.data = torch.ones_like(conv.weight)
    for c in range(2 * dim):
        x2 = torch.zeros(1, 3, 9, 2 * dim)
        x2[..., c] = 1.0
        with torch.no_grad():
            y = token_fuse(x2, conv, (0, 3))
        moved = [g for g in range(dim) if y[..., g].abs().max() > 0]
        assert moved == [c // 2], (c, moved)


@pytest.mark.parametrize("hw,L", [((6, 6), 4), ((5, 7), 4), ((3, 9), 7)])
def test_morph_fc_pad_and_crop_equal_jax(hw, L):
    from jittor_mlp_tpu.models.morph_mlp import _morph_fc
    from jittor_mlp_tpu_torch.models.morph_mlp import MorphFC, morph_fc

    rng = np.random.default_rng(1)
    dim = 8
    x = rng.standard_normal((2, *hw, dim)).astype(np.float32)
    m = MorphFC(dim)
    params = {}
    for fc in ("fc_h", "fc_w", "fc_c"):
        w = rng.standard_normal((dim, dim, 1, 1)).astype(np.float32)
        b = rng.standard_normal(dim).astype(np.float32)
        getattr(m, fc).weight.data, getattr(m, fc).bias.data = torch.from_numpy(w), torch.from_numpy(b)
        params[fc] = {"weight": w, "bias": b}
    with jconfig.parity_mode():
        want = np.asarray(_morph_fc(params, x, L))
    with config.parity_mode(), torch.no_grad():
        got = morph_fc(m, torch.from_numpy(x), L)
    assert got.shape == x.shape
    assert_close(got.numpy(), want, tol=1e-5, name="morph_fc")


def test_conv_mlp_without_head_returns_the_map():
    kw = {**tp.CONV_MLP, "classifier_head": False}
    jmodel = jconv_mlp.ConvMLP(**kw)
    port = tconv_mlp.ConvMLP(**kw, **tp.CPU).eval()
    assert "head.weight" not in port.state_dict() and "norm.weight" not in port.state_dict()
    tp.check_convert("conv_mlp", jconv_mlp.ConvMLP, tconv_mlp.ConvMLP, kw)
    x = tp.images((2, 3, 64, 64))
    with jconfig.parity_mode():
        want = np.asarray(jmodel(x))
    with config.parity_mode(), torch.inference_mode():
        got = port(x).numpy()
    assert got.shape == want.shape == (2, 4, 4, 64)  # NHWC, as JAX returns it
    assert_close(got, want, tol=1e-4, name="conv_mlp headless")


@pytest.mark.parametrize("arch", ["convmlp_s", "convmlp_m", "convmlp_l"])
def test_convmlp_factories_match_jax(arch):
    want = getattr(jm, arch)()._init_sd
    got = getattr(jt, arch)(**tp.CPU).state_dict()
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    np.testing.assert_array_equal(got["head.weight"].numpy(), want["head.weight"])


def test_convmlp_pretrained_needs_a_local_file(tmp_path, monkeypatch):
    monkeypatch.setenv("JITTOR_MLP_TPU_CKPT_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="convmlp_s_imagenet.pth"):
        jt.convmlp_s(pretrained=True, **tp.CPU)
    src = jt.convmlp_s(seed=3, **tp.CPU)
    torch.save({"model": src.state_dict()}, tmp_path / "convmlp_s_imagenet.pth")
    model = jt.convmlp_s(pretrained=True, **tp.CPU)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_pretrained_path_loads_into_wave_and_morph(tmp_path):
    with tp.wave_xs(), tp.morph_xs():
        for factory in (jt.WaveMLP, jt.MorphMLP):
            src = factory(**(tp.WAVE if factory is jt.WaveMLP else tp.MORPH), seed=4, **tp.CPU)
            path = tmp_path / f"{src.name}.pth"
            torch.save({"model": src.state_dict()}, path)
            model = factory(model_name="XS", num_classes=10, pretrained=str(path), **tp.CPU)
            for k, v in src.state_dict().items():
                assert torch.equal(model.state_dict()[k], v), k


def test_jax_and_port_settings_tables_agree():
    from jittor_mlp_tpu.models import morph_mlp as jmorph
    from jittor_mlp_tpu.models import sequencer as jseq
    from jittor_mlp_tpu.models import wave_mlp as jwave
    from jittor_mlp_tpu_torch.models import morph_mlp as tmorph
    from jittor_mlp_tpu_torch.models import sequencer as tseq
    from jittor_mlp_tpu_torch.models import wave_mlp as twave

    # other tests may add settings to the JAX tables: each of the port's
    # settings is JAX's, and the published ones are there
    for port, ref, names in ((tmorph.morphmlp_settings, jmorph.morphmlp_settings, "TSBL"),
                             (twave.wavemlp_settings, jwave.wavemlp_settings, "TSM"),
                             (tseq.sequencer_settings, jseq.sequencer_settings, "SML")):
        assert set(names) <= set(port)
        for k, v in port.items():
            assert ref[k] == v, k
    with pytest.raises(ValueError, match="model_name"):
        jt.WaveMLP(model_name="Q", **tp.CPU)
