"""Bidirectional LSTM (counterpart of ``jittor_mlp_tpu/ops/lstm.py``).

``bilstm`` runs an ``nn.LSTM(input, hidden, batch_first=True,
bidirectional=True)``: cuDNN's RNN on the card, in the dtype of its weights
and input (bf16 included), ATen's LSTM on the CPU. The parameters carry
the torch names ``weight_ih_l0`` (4H, C), ``weight_hh_l0`` (4H, H),
``bias_ih_l0`` and ``bias_hh_l0`` (4H,) and their ``_reverse`` twins; the
gate order is i, f, g, o. The JAX package's ``lax.scan`` over all
sequences at once is a TPU lowering and is not ported.

``bilstm_plain`` is that step loop written in PyTorch: the input
projections of all steps as one product with ``b_ih + b_hh`` added, then
per step ``gates = xp_t + h W_hhᵀ``, ``c = σ(f)·c + σ(i)·tanh(g)``,
``h = σ(o)·tanh(c)``, h and c in x's dtype. It is the oracle of the tests
and of chip_smoke.py; no model calls it.

``LSTM`` is the ``nn.LSTM`` the models hold. torch's
``flatten_parameters()`` leaves bf16 weights where they are
(``torch.backends.cudnn.is_acceptable`` refuses bf16), though cuDNN's RNN
runs bf16; cuDNN then copies the eight tensors into one buffer at every
call and warns. ``LSTM.flatten_parameters`` lays bf16 weights on the card
out in cuDNN's buffer as torch does for float32 and float16.
"""

from __future__ import annotations

import torch
from torch import nn

_NAMES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


class LSTM(nn.LSTM):
    """``nn.LSTM(input_size, hidden_size, batch_first=True,
    bidirectional=True)``, its weights kept in cuDNN's buffer in bf16 too.
    ``_apply`` (``to``, ``cuda``, ``bfloat16``) calls
    ``flatten_parameters()``, and so does every ``load_state_dict`` that
    reaches this module (a post-hook)."""

    def __init__(self, input_size, hidden_size):
        super().__init__(input_size, hidden_size, batch_first=True, bidirectional=True)
        self.register_load_state_dict_post_hook(lambda m, _keys: m.flatten_parameters())

    def flatten_parameters(self):
        fw = self._flat_weights
        if not (len(fw) == len(self._flat_weights_names)
                and all(isinstance(w, torch.Tensor) and w.is_cuda
                        and w.dtype == torch.bfloat16 for w in fw)
                and torch.backends.cudnn.enabled
                and len({w.data_ptr() for w in fw}) == len(fw)):
            return super().flatten_parameters()
        from torch.backends.cudnn import rnn

        with torch.cuda.device_of(fw[0]), torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                fw, 4, self.input_size, rnn.get_cudnn_mode(self.mode), self.hidden_size,
                self.proj_size, self.num_layers, self.batch_first, bool(self.bidirectional))


def bilstm(lstm, x):
    """x (N, T, C) → (N, T, 2H): the forward direction's outputs, then the
    backward direction's, through ``lstm`` (an ``LSTM``) from zero states."""
    y, _ = lstm(x)
    return y


def _scan(x, w_ih, w_hh, b, reverse):
    N, T, _ = x.shape
    H = w_hh.shape[1]
    xp = torch.matmul(x, w_ih.t()) + b  # (N, T, 4H)
    h = x.new_zeros(N, H)
    c = x.new_zeros(N, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (xp[:, t] + torch.matmul(h, w_hh.t())).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, 1)


def bilstm_plain(params, x):
    """The JAX ``bilstm`` step loop on ``params`` (an LSTM's state dict:
    torch name → tensor, the ``_reverse`` twins included) in x's dtype:
    (N, T, C) → (N, T, 2H)."""
    outs = []
    for suffix, reverse in (("", False), ("_reverse", True)):
        w_ih, w_hh, b_ih, b_hh = (params[n + suffix].to(x.dtype) for n in _NAMES)
        outs.append(_scan(x, w_ih, w_hh, b_ih + b_hh, reverse))
    return torch.cat(outs, -1)
