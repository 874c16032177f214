"""The port's int8 checkpoints (``quant.quantized_nbytes``, ``save_quantized``,
``load_quantized``) against jittor_mlp_tpu's, on the CPU.

- ``quantized_nbytes`` of the port's ``quantize_state_dict`` equals JAX's of
  ``quantize_tree`` on the same weights;
- the ``save_quantized`` payload (codes and scales) equals the JAX
  ``quantize_tree`` leaves bit for bit, unstacked by
  ``convert.state_dict_from_jax``;
- a JAX ``save_quantized`` file loads into the port: ``load_quantized(
  float32)`` logits within 1e-4 of JAX ``load_quantized`` + apply, for the
  Mixer, ResMLP, AS-MLP, Hire-MLP and CycleMLP;
- the port's own file: ``load_quantized`` equals
  ``dequantize_state_dict(quantize_state_dict(...))`` bit for bit, in
  float32 and bf16, and the file is smaller than 0.35 × the float32
  ``save_params`` file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from conftest import assert_close
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu import quant as jquant
from jittor_mlp_tpu.models.cycle_mlp import CycleNet as JCycleNet
from jittor_mlp_tpu.utils import serialization as jser
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch import quant as tquant
from jittor_mlp_tpu_torch.convert import state_dict_from_jax
from jittor_mlp_tpu_torch.models.cycle_mlp import CycleNet
from jittor_mlp_tpu_torch.utils import serialization as tser

# widths where most weights are eligible (≥ 2048 elements)
MIXER = dict(image_size=32, patch_size=4, d_model=64, depth=2, num_classes=10, token_dim=64)
RES = dict(d_model=64, num_classes=10, patch_size=4, image_size=32, depth=2)
GMLP = dict(d_model=64, d_ffn=128, num_classes=10, patch_size=4, image_size=32, depth=2)
AS = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=32, depths=[2, 2],
          shift_size=3, drop_path_rate=0.1)
CASES = {
    "mlp_mixer": (jm.MLPMixerForImageClassification, jt.MLPMixerForImageClassification, MIXER),
    "res_mlp": (jm.ResMLPForImageClassification, jt.ResMLPForImageClassification, RES),
    "g_mlp": (jm.gMLPForImageClassification, jt.gMLPForImageClassification, GMLP),
    "as_mlp": (jm.AS_MLP, jt.AS_MLP, AS),
    "hire_mlp": (jm.HireMLP, jt.HireMLP, tp.HIRE),
    "cycle_mlp": (JCycleNet, CycleNet, tp.CYCLE),
}
DENSE = ["mlp_mixer", "res_mlp", "g_mlp"]


def _pair(name, seed=1):
    jf, tf, kw = CASES[name]
    jmodel = jf(**kw, seed=seed)
    tmodel = tf(**kw, seed=seed, **tp.CPU)
    return jmodel, tmodel


@pytest.mark.parametrize("name", DENSE)
def test_quantized_nbytes_equals_jax(name):
    jmodel, tmodel = _pair(name)
    want = jquant.quantized_nbytes(jquant.quantize_tree(jax.tree.map(np.asarray,
                                                                     jmodel.params)))
    got = tquant.quantized_nbytes(tquant.quantize_state_dict(name, tmodel.state_dict()))
    assert got == want


def _replace_quantized(tree, part):
    """A JAX quantize_tree with each quantized node replaced by its codes
    (part 0) or its scales (part 1)."""
    if isinstance(tree, dict):
        if "__q_int8__" in tree:
            return tree[("__q_int8__", "__q_scale__")[part]]
        return {k: _replace_quantized(v, part) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace_quantized(v, part) for v in tree)
    return tree


@pytest.mark.parametrize("name", DENSE)
def test_save_quantized_payload_equals_jax_quantize_tree(name, tmp_path):
    jmodel, tmodel = _pair(name)
    q = jquant.quantize_tree(jax.tree.map(np.asarray, jmodel.params))
    want_q = state_dict_from_jax(name, jax.tree.map(np.asarray, _replace_quantized(q, 0)))
    want_s = state_dict_from_jax(name, jax.tree.map(np.asarray, _replace_quantized(q, 1)))
    path = tquant.save_quantized(tmodel, str(tmp_path / "m.int8.npz"))
    n_quantized = 0
    with np.load(path) as data:
        for key in data.files:
            if key.endswith("::q"):
                k = key[:-3]
                assert data[key].dtype == np.int8
                np.testing.assert_array_equal(data[key], want_q[k].numpy(), err_msg=k)
                np.testing.assert_array_equal(data[k + "::scale"], want_s[k].numpy(), err_msg=k)
                n_quantized += 1
            elif not key.endswith("::scale"):
                np.testing.assert_array_equal(data[key], want_q[key].numpy(), err_msg=key)
    assert n_quantized >= 4


@pytest.mark.parametrize("name", list(CASES))
def test_jax_save_quantized_file_loads_into_the_port(name, tmp_path):
    jf, tf, kw = CASES[name]
    path = jquant.save_quantized(jf(**kw, seed=1), str(tmp_path / "jax.int8.npz"))
    jmodel = jquant.load_quantized(jf(**kw, seed=2), path, dtype=jnp.float32)
    tmodel = tquant.load_quantized(tf(**kw, seed=3, **tp.CPU).eval(), path, dtype=torch.float32)
    x = tp.images((2, 3, 32, 32))
    with jconfig.parity_mode():
        want = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(x)))
    with config.parity_mode(), torch.inference_mode():
        got = tmodel(x).numpy()
    assert_close(got, want, tol=1e-4, name=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["mlp_mixer", "as_mlp", "cycle_mlp"])
def test_own_file_round_trip(name, dtype, tmp_path):
    _, tmodel = _pair(name)
    want = tquant.dequantize_state_dict(
        tquant.quantize_state_dict(name, tmodel.state_dict()), dtype)
    path = tquant.save_quantized(tmodel, str(tmp_path / "m.int8.npz"))
    _, fresh = _pair(name, seed=5)
    got = tquant.load_quantized(fresh, path, dtype=dtype).state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_int8_file_is_a_third_of_the_f32_file(tmp_path):
    _, tmodel = _pair("mlp_mixer")
    f32 = tser.save_params(tmodel, str(tmp_path / "m.npz"))
    q = tquant.save_quantized(tmodel, str(tmp_path / "m.int8.npz"))
    ratio = os.path.getsize(q) / os.path.getsize(f32)
    assert ratio < 0.35, ratio
    nbytes = tquant.quantized_nbytes(tquant.quantize_state_dict("mlp_mixer",
                                                                tmodel.state_dict()))
    f32_bytes = sum(v.numel() * 4 for v in tmodel.state_dict().values())
    assert nbytes < 0.35 * f32_bytes


def test_eval_load_weights_reads_every_kind(tmp_path):
    """examples/eval.load_weights: .pth (strict), a JAX .npz and a JAX
    .int8.npz, each into a model built from another seed."""
    from jittor_mlp_tpu_torch.examples.eval import load_weights

    jf, tf, kw = CASES["mlp_mixer"]
    jmodel = jf(**kw, seed=1)
    want = jmodel.export_torch_state_dict(tensors=False)
    pth = tmp_path / "m.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in want.items()}}, pth)
    npz = jser.save_params(jmodel, str(tmp_path / "m.npz"))
    q = jquant.save_quantized(jmodel, str(tmp_path / "m.int8.npz"))
    for path in (str(pth), npz):
        got = load_weights(tf(**kw, seed=2, **tp.CPU), path).state_dict()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    got = load_weights(tf(**kw, seed=2, **tp.CPU), q, bf16=True)
    assert next(got.parameters()).dtype == torch.bfloat16
