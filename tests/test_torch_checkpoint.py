"""The port's ``utils.checkpoint`` on the CPU: a local ``.pth`` that the test
writes round-trips, with or without the reference's ``{'model': sd}``
wrapper; a bare file name is found in ``$JITTOR_MLP_TPU_CKPT_DIR``; a URL
raises (the port never downloads), as does a published name that is not
in that directory."""

import pytest
import torch

import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu_torch.utils.checkpoint import load_pretrained, load_torch_checkpoint


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
