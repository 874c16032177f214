"""The port's ``utils.checkpoint`` on the CPU: a local ``.pth`` that the test
writes round-trips, with or without the reference's ``{'model': sd}``
wrapper; a bare file name is found in ``$JITTOR_MLP_TPU_CKPT_DIR``; a URL
raises (the port never downloads), as does a published name that is not
in that directory. GFNet's helpers against the JAX package's:
``resize_pos_embed`` within 1e-6 (jax.image.resize's bilinear
antialiases when it shrinks), shrinking and growing, with and without a
class token; ``gfnet_checkpoint_filter`` reshapes a 3-D patch-embedding
weight and resizes a position embedding of another grid, as JAX's does,
and the filtered checkpoint loads."""

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu.utils import checkpoint as jckpt
from jittor_mlp_tpu_torch.utils.checkpoint import (gfnet_checkpoint_filter, load_pretrained,
                                                   load_torch_checkpoint, resize_pos_embed)


@pytest.mark.parametrize("wrapped", [True, False], ids=["model_key", "bare"])
def test_round_trip_through_a_local_pth(tmp_path, wrapped):
    src = jt.ConvMixer(**tp.CONV_MIXER, seed=2, **tp.CPU)
    sd = src.state_dict()
    path = tmp_path / "convmixer.pth"
    torch.save({"model": sd} if wrapped else sd, path)
    got = load_torch_checkpoint(path)
    assert sorted(got) == sorted(sd)
    model = jt.ConvMixer(**tp.CONV_MIXER, **tp.CPU).load_torch_state_dict(got)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_bare_name_resolves_in_the_checkpoint_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("JITTOR_MLP_TPU_CKPT_DIR", str(tmp_path))
    torch.save({"model": {"w": torch.arange(3.0)}}, tmp_path / "staged.pth")
    assert torch.equal(load_torch_checkpoint("staged.pth")["w"], torch.arange(3.0))
    assert torch.equal(load_torch_checkpoint("/elsewhere/staged.pth")["w"], torch.arange(3.0))
    assert torch.equal(load_pretrained("staged.pth")["w"], torch.arange(3.0))
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        load_pretrained("missing.pth")


@pytest.mark.parametrize("url", ["https://example.com/m.pth", "http://example.com/m.pth"])
def test_url_raises(url):
    with pytest.raises(ValueError, match="local files only"):
        load_torch_checkpoint(url)


@pytest.mark.parametrize("cls_token", [False, True], ids=["grid", "cls_token"])
@pytest.mark.parametrize("old,new", [(14, 7), (14, 10), (7, 12), (4, 9)],
                         ids=["14to7", "14to10", "7to12", "4to9"])
def test_resize_pos_embed_matches_jax(old, new, cls_token):
    n = old * old + cls_token
    pe = np.random.default_rng(old + new).standard_normal((1, n, 6)).astype(np.float32)
    want = np.asarray(jckpt.resize_pos_embed(pe, new * new + cls_token, cls_token))
    got = resize_pos_embed(torch.from_numpy(pe), new * new + cls_token, cls_token)
    assert got.shape == want.shape == (1, new * new + cls_token, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(resize_pos_embed(pe, new * new + cls_token, cls_token).numpy(),
                               want, rtol=0, atol=1e-6)  # an array in


GF = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=16, depth=1)


def test_gfnet_checkpoint_filter_matches_jax(tmp_path):
    """A checkpoint of a GFNet at img 56 (a 7 × 7 grid) with its patch
    embedding flattened to (O, C·p, p), filtered for a model at img 32
    (4 × 4): the same tensors as JAX's filter gives, and the two it
    changed load (the filters' grids differ, and neither filter resizes
    them)."""
    src = jt.GFNet(**{**GF, "img_size": 56}, seed=3, **tp.CPU).state_dict()
    src["patch_embed.proj.weight"] = src["patch_embed.proj.weight"].reshape(16, 24, 8)
    ckpt = {"model": src}
    model = jt.GFNet(**GF, **tp.CPU)
    got = gfnet_checkpoint_filter(ckpt, model)
    want = jckpt.gfnet_checkpoint_filter(ckpt, jm.GFNet(**GF))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
    assert got["patch_embed.proj.weight"].shape == (16, 3, 8, 8)
    assert got["pos_embed"].shape == (1, 16, 16)
    changed = ("pos_embed", "patch_embed.proj.weight")
    model.load_state_dict({k: got[k] for k in changed}, strict=False)
    for k in changed:
        assert torch.equal(model.state_dict()[k], got[k]), k
    same = gfnet_checkpoint_filter(model.state_dict(), model)  # nothing to change
    for k, v in model.state_dict().items():
        assert torch.equal(same[k], v), k
