"""The port's ``utils.serialization`` on the CPU.

- The port's own ``.npz`` snapshot round-trips bit for bit (float32 and
  bf16 models, a BatchNorm family's buffers included).
- A file that the JAX package's ``save_params`` wrote loads into the port
  (``parse_treedef`` + ``fill_leaves`` + ``convert.state_dict_from_jax``):
  the logits within 1e-4 of the JAX model's ``apply`` on the same input, for
  the Mixer and ResMLP (stacked blocks), AS-MLP (a list of stages, with
  ``_dpr`` leaves), Hire-MLP (its unused last merge from the template,
  ``_step`` leaves) and CycleMLP (offsets made again).
- The train state: two steps straight through equal one step, save,
  restore into fresh objects, one step, bit for bit (losses and state
  dicts), with a BatchNorm family and a drop-path family whose generator
  state is restored too.
"""

import jax
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from conftest import assert_close
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.models.cycle_mlp import CycleNet as JCycleNet
from jittor_mlp_tpu.utils import serialization as jser
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.models.cycle_mlp import CycleNet
from jittor_mlp_tpu_torch.parallel import make_train_step
from jittor_mlp_tpu_torch.utils import serialization as tser

MIXER = dict(image_size=32, patch_size=8, d_model=32, depth=2, num_classes=10)
RES = dict(d_model=48, num_classes=10, patch_size=8, image_size=32, depth=3)
AS = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2],
          shift_size=3, drop_path_rate=0.1)
# name: (JAX factory, port factory, kwargs, image side)
CASES = {
    "mlp_mixer": (jm.MLPMixerForImageClassification, jt.MLPMixerForImageClassification, MIXER,
                  32),
    "res_mlp": (jm.ResMLPForImageClassification, jt.ResMLPForImageClassification, RES, 32),
    "as_mlp": (jm.AS_MLP, jt.AS_MLP, AS, 32),
    "hire_mlp": (jm.HireMLP, jt.HireMLP, tp.HIRE, 32),
    "cycle_mlp": (JCycleNet, CycleNet, tp.CYCLE, 32),
}


def _state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,bf16", [("mlp_mixer", False), ("mlp_mixer", True),
                                       ("as_mlp", False), ("conv_mixer", False)])
def test_own_format_round_trip_is_exact(name, bf16, tmp_path):
    factory, kw = ((jt.ConvMixer, tp.CONV_MIXER) if name == "conv_mixer"
                   else CASES[name][1:3])
    src = factory(**kw, seed=3, **tp.CPU)
    if bf16:
        src.to_bf16()
    if name == "conv_mixer":  # running statistics away from their init
        for k, v in src.state_dict().items():
            if k.endswith("running_var"):
                v.mul_(1.5)
    path = tser.save_params(src, str(tmp_path / "m.npz"))
    dst = factory(**kw, seed=4, **tp.CPU)
    if bf16:
        dst.to_bf16()
    tser.load_params(dst, path)
    _state_equal(dst.state_dict(), src.state_dict())
    x = torch.from_numpy(tp.images((2, 3, 32, 32)))
    with torch.inference_mode():
        dt = torch.bfloat16 if bf16 else torch.float32
        assert torch.equal(dst.eval().forward(x.to(dt)), src.eval().forward(x.to(dt)))


@pytest.mark.parametrize("name", list(CASES))
def test_jax_save_params_file_loads_into_the_port(name, tmp_path):
    jf, tf, kw, hw = CASES[name]
    jmodel = jf(**kw, seed=1)
    path = jser.save_params(jmodel, str(tmp_path / "jax.npz"))
    tmodel = tf(**kw, seed=2, **tp.CPU).eval()
    tser.load_params(tmodel, path)
    x = tp.images((2, 3, hw, hw))
    with jconfig.parity_mode():
        want = np.asarray(jmodel.apply(jmodel.params, jax.numpy.asarray(x)))
    with config.parity_mode(), torch.inference_mode():
        got = tmodel(x).numpy()
    assert_close(got, want, tol=1e-4, name=name)


def test_jax_bf16_snapshot_loads_bit_for_bit(tmp_path):
    """JAX writes bf16 leaves as raw 2-byte records (numpy reads them as
    ``V2``): they load as the same bf16 values."""
    jmodel = jm.MLPMixerForImageClassification(**MIXER, seed=1)
    jmodel.to_bf16()
    path = jser.save_params(jmodel, str(tmp_path / "bf16.npz"))
    with np.load(path) as data:
        assert data["leaf_00000"].dtype == np.dtype("V2")
    tmodel = tser.load_params(jt.MLPMixerForImageClassification(**MIXER, seed=2, **tp.CPU)
                              .to_bf16(), path)
    want = state_dict_from_jax("mlp_mixer", jax.tree.map(
        lambda v: np.asarray(v, np.float32), jmodel.params))
    for k, v in tmodel.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v.float(), want[k]), k


def test_load_params_refuses_another_model(tmp_path):
    path = jser.save_params(jm.MLPMixerForImageClassification(**MIXER), str(tmp_path / "j.npz"))
    other = jt.MLPMixerForImageClassification(**{**MIXER, "depth": 3}, **tp.CPU)
    with pytest.raises((RuntimeError, KeyError, ValueError)):
        tser.load_params(other, path)


def test_parse_treedef_and_fill_in_flatten_order():
    tree = {"b": [1.0, (2.0, {"z": 3.0, "a": 4.0})], "a": {"y": None, "x": 5.0}}
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    parsed = tser.parse_treedef(str(treedef))
    assert tser.fill_leaves(parsed, leaves) == tree
    with pytest.raises(ValueError):
        tser.fill_leaves(parsed, leaves + [6.0])
    with pytest.raises(ValueError):
        tser.parse_treedef("{'a': *}")


# name: (port factory, kwargs, image side, drop-path)
TRAIN = {
    "mlp_mixer": (jt.MLPMixerForImageClassification, MIXER, 32, False),
    "conv_mixer": (jt.ConvMixer, tp.CONV_MIXER, 32, False),
    "as_mlp": (jt.AS_MLP, {**AS, "drop_path_rate": 0.5}, 32, True),
}


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_state_resumes_bit_for_bit(name, tmp_path):
    factory, kw, hw, stochastic = TRAIN[name]
    batches = [tp.train_batch((4, 3, hw, hw), seed=s) for s in (0, 1)]

    def fresh():
        model = factory(**kw, seed=0, **tp.CPU)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2, eps=1e-4)
        gen = torch.Generator().manual_seed(7) if stochastic else None
        return model, opt, make_train_step(model, opt), gen

    model, opt, step, gen = fresh()
    straight = [step(b, generator=gen) for b in batches]
    want = {k: v.clone() for k, v in model.state_dict().items()}

    model, opt, step, gen = fresh()
    first = step(batches[0], generator=gen)
    path = tser.save_train_state(str(tmp_path / "state.pt"), model, opt, 1, generator=gen)
    model, opt, step, gen = fresh()
    if gen is not None:
        gen.manual_seed(99)  # the restore must bring the saved state back
    assert tser.restore_train_state(path, model, opt, generator=gen) == 1
    second = step(batches[1], generator=gen)
    assert torch.equal(first, straight[0]) and torch.equal(second, straight[1])
    _state_equal(model.state_dict(), want)
    if name == "conv_mixer":  # the running statistics took both steps
        init = factory(**kw, seed=0, **tp.CPU).state_dict()
        assert not torch.equal(want["blocks.0.0.fn.2.running_mean"],
                               init["blocks.0.0.fn.2.running_mean"])
