"""The port's Sequencer2D and ops/lstm.py against jittor_mlp_tpu's, on the
CPU (tests/torch_parity.py).

At the "XS" setting of tools/parity_report.py (depths [1, 1], dims
[16, 32], hidden [8, 8], expansion 2; img 28), added to both packages'
``sequencer_settings``: the same seed gives the same weights; the JAX
params (a stage's patch conv ``stages.{s}.0``, its blocks stacked as
``stages.{s}.1.model``) convert to the port's state dict; float32 logits
within 1e-4 of the JAX forward; bf16 and int8_mode() within their bands;
Predictor's batched answers equal single ones. The weights="int8" state
dict is bit-equal to JAX's at "XS" and at Sequencer2D-S, whose stacked
LSTM weights (L, 4H, C) get one scale per (block, gate row).

``bilstm`` (nn.LSTM, bidirectional, batch first) and ``bilstm_plain``
(the JAX step loop in PyTorch) against the JAX ``bilstm`` on the same
weights: within 1e-5 of max|ref| in float32; bf16 stays bf16. The
LSTM modules compact their weights again after every load_state_dict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
import torch_parity as tp
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.ops import lstm as jlstm
from jittor_mlp_tpu_torch.ops import lstm as tlstm

SHAPE = (2, 3, 28, 28)


@pytest.fixture(autouse=True)
def xs_setting():
    with tp.sequencer_xs():
        yield


def test_same_seed_same_weights():
    got = tp.check_same_seed(jm.Sequencer2D, jt.Sequencer2D, tp.SEQ)
    assert got["stages.1.1.model.0.0.fn.0.rnn_h.weight_ih_l0_reverse"].shape == (32, 32)
    assert got["stages.0.1.model.0.0.fn.0.fc.weight"].shape == (16, 32)
    assert got["mlp_head.1.weight"].shape == (10, 32)


def test_state_dict_from_jax_equals_export():
    tp.check_convert("sequencer", jm.Sequencer2D, jt.Sequencer2D, tp.SEQ)


def test_f32_logits_match_jax():
    tp.check_port_parity(jm.Sequencer2D, jt.Sequencer2D, tp.SEQ, SHAPE, name="sequencer")


def test_bf16_logits_within_band_of_jax_f32():
    tp.check_bf16(jm.Sequencer2D, jt.Sequencer2D, tp.SEQ, (8, 3, 28, 28))


def test_int8_logits_within_band_of_jax_int8_mode():
    tp.check_int8(jm.Sequencer2D, jt.Sequencer2D, tp.SEQ, (8, 3, 28, 28))


@pytest.mark.parametrize("kw", [tp.SEQ, dict(model_name="S", num_classes=10)],
                         ids=["xs", "sequencer_s"])
def test_int8_state_dict_equals_jax_dequantize_tree(kw):
    q = tp.check_int8_state_dict("sequencer", jm.Sequencer2D, jt.Sequencer2D, kw)
    pre = "stages.0.1.model.3.0.fn.0.rnn_v." if kw["model_name"] == "S" \
        else "stages.0.1.model.0.0.fn.0.rnn_v."
    w = q[pre + "weight_ih_l0"]
    if kw["model_name"] == "S":  # (4, 192, 192) stacked: a scale a (block, gate row)
        assert isinstance(w, dict) and w["scale"].shape == (192, 1)
        assert isinstance(q[pre + "weight_hh_l0_reverse"], dict)
        assert not isinstance(q[pre + "bias_ih_l0"], dict)  # (4, 192): too few
        b = q["stages.2.1.model.5.0.fn.0.rnn_h.bias_hh_l0"]  # (8, 384): a scale a block
        assert isinstance(b, dict) and b["scale"].shape == (1,)
    else:  # (1, 32, 16): too few
        assert not isinstance(w, dict)


@pytest.mark.parametrize("opts", tp.PREDICTOR_OPTS, ids=tp.PREDICTOR_IDS)
def test_predictor_batched_equals_alone(opts):
    tp.check_predictor(jt.Sequencer2D, tp.SEQ, 28, opts)


def test_factory_options(tmp_path):
    tp.check_factory_device(jt.Sequencer2D, tp.SEQ)
    with pytest.raises(ValueError, match="model_name"):
        jt.Sequencer2D(model_name="XXL", **tp.CPU)
    src = jt.Sequencer2D(**tp.SEQ, seed=4, **tp.CPU)
    assert src.name == "sequencer"
    path = tmp_path / "sequencer.pth"
    torch.save({"model": src.state_dict()}, path)
    model = jt.Sequencer2D(**tp.SEQ, pretrained=str(path), **tp.CPU)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def _lstm_params(C, H, seed):
    r = np.random.default_rng(seed)
    p = {}
    for suf in ("", "_reverse"):
        p[f"weight_ih_l0{suf}"] = r.uniform(-0.5, 0.5, (4 * H, C)).astype(np.float32)
        p[f"weight_hh_l0{suf}"] = r.uniform(-0.5, 0.5, (4 * H, H)).astype(np.float32)
        p[f"bias_ih_l0{suf}"] = r.uniform(-0.5, 0.5, 4 * H).astype(np.float32)
        p[f"bias_hh_l0{suf}"] = r.uniform(-0.5, 0.5, 4 * H).astype(np.float32)
    return p


def _within(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{err:.3e} > {tol} of {np.abs(want).max():.3e}"


@pytest.mark.parametrize("N,T,C,H", [(5, 7, 6, 4), (12, 16, 16, 8)])
def test_bilstm_matches_jax(N, T, C, H):
    p = _lstm_params(C, H, seed=T)
    x = np.random.default_rng(1).standard_normal((N, T, C)).astype(np.float32)
    with jconfig.parity_mode():
        want = np.asarray(jlstm.bilstm({k: jnp.asarray(v) for k, v in p.items()},
                                       jnp.asarray(x)))
    lstm = tlstm.LSTM(C, H)
    lstm.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = tlstm.bilstm(lstm, xt)
        plain = tlstm.bilstm_plain(dict(lstm.state_dict()), xt)
    assert got.shape == (N, T, 2 * H)
    _within(got.numpy(), want, 1e-5)
    _within(plain.numpy(), want, 1e-6)


def test_bilstm_bf16_runs_in_bf16():
    p = _lstm_params(8, 4, seed=3)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 9, 8)).astype(np.float32))
    lstm = tlstm.LSTM(8, 4)
    lstm.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        want = tlstm.bilstm(lstm, x)
        lstm.bfloat16()
        got = tlstm.bilstm(lstm, x.bfloat16())
        plain = tlstm.bilstm_plain(dict(lstm.state_dict()), x.bfloat16())
    assert got.dtype == plain.dtype == torch.bfloat16
    _within(got.float().numpy(), want.numpy(), 3e-2)
    _within(plain.float().numpy(), want.numpy(), 3e-2)


def test_lstm_flattens_after_load_state_dict(monkeypatch):
    calls = []
    monkeypatch.setattr(tlstm.LSTM, "flatten_parameters", lambda self: calls.append(self))
    model = jt.Sequencer2D(**tp.SEQ, **tp.CPU)
    calls.clear()
    model.load_state_dict(model.state_dict())
    lstms = [m for m in model.modules() if isinstance(m, tlstm.LSTM)]
    assert len(lstms) == 4 and sorted(map(id, calls)) == sorted(map(id, lstms))


def test_profile_blocks_counts_lstm_and_fft_kernels_by_their_op(capsys):
    """profile_blocks' LSTM and FFT kinds: the kernels launched inside
    aten::lstm (a cuDNN RNN kernel and a product) and the FFT ops go to
    those kinds once, however deep the op, and a runtime event that
    repeats a kernel adds nothing; the rest of a kernel's time stays with
    its own kind."""
    from types import SimpleNamespace as E

    from jittor_mlp_tpu_torch.tools import profile_blocks as pb

    def ev(name, kernels=(), children=()):
        e = E(name=name, kernels=[E(name=k, duration=d) for k, d in kernels],
              cpu_children=list(children), cpu_parent=None)
        for c in e.cpu_children:
            c.cpu_parent = e
        return e

    again = ev("Command Buffer Full", [("elemWiseRNNcell", 300.0)])  # a runtime event
    rnn = ev("aten::_cudnn_rnn", [("elemWiseRNNcell", 300.0), ("nvjet_tst_gemm", 100.0)],
             children=[again])
    lstm = ev("aten::lstm", children=[rnn])
    r2c = ev("aten::_fft_r2c", [("regular_fft_factor", 50.0)])
    rfft = ev("aten::fft_rfft2", children=[r2c])
    mm = ev("aten::mm", [("nvjet_tst_gemm", 200.0)])
    by_op = pb.op_kernels([lstm, rnn, again, rfft, r2c, mm], iters=2)
    assert by_op == {("elemWiseRNNcell", "LSTM (cuDNN RNN)"): 0.15,
                     ("nvjet_tst_gemm", "LSTM (cuDNN RNN)"): 0.05,
                     ("regular_fft_factor", "FFTs (cuFFT)"): 0.025}
    rows = [("nvjet_tst_gemm", 0.15, 2), ("elemWiseRNNcell", 0.15, 1),
            ("regular_fft_factor", 0.025, 1)]
    capsys.readouterr()
    pb.report("t", rows, 1.0, 3, by_op)
    kinds = capsys.readouterr().out.splitlines()[2]
    assert "LSTM (cuDNN RNN) 0.200 ms" in kinds and "FFTs (cuFFT) 0.025 ms" in kinds
    assert "library products 0.100 ms" in kinds
