"""Parameter initialization matching torch defaults, plus a state-dict builder.

A copy of ``jittor_mlp_tpu/core/init.py`` in numpy and scipy only. Models build
a dotted-key state dict of numpy arrays with exactly the keys and shapes of
their torch ``state_dict`` and load it into their modules, so the port and the
JAX package built with the same ``seed`` hold the same weights, bit for bit.

trunc_normal is the inverse-CDF scheme (U(erf(a/√2), erf(b/√2)) → erfinv).
Linear/Conv default init is torch's kaiming_uniform(a=sqrt(5)), i.e.
U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import special as _sp

__all__ = ["SDBuilder", "trunc_normal"]


def trunc_normal(rng, shape, mean=0.0, std=1.0, a=-2.0, b=2.0):
    """Truncated normal via inverse CDF."""
    lo = _sp.erf((a - mean) / (std * math.sqrt(2.0)))
    hi = _sp.erf((b - mean) / (std * math.sqrt(2.0)))
    u = rng.uniform(lo, hi, size=shape)
    x = _sp.erfinv(u) * std * math.sqrt(2.0) + mean
    return np.clip(x, a, b).astype(np.float32)


class SDBuilder:
    """Accumulates a torch-layout state dict of freshly initialized arrays."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.sd: dict = {}

    def param(self, name, array):
        self.sd[name] = np.asarray(array, dtype=np.float32)
        return self

    def _kaiming_uniform(self, shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return self.rng.uniform(-bound, bound, size=shape).astype(np.float32)

    def linear(self, name, in_f, out_f, bias=True):
        self.sd[f"{name}.weight"] = self._kaiming_uniform((out_f, in_f), in_f)
        if bias:
            self.sd[f"{name}.bias"] = self._kaiming_uniform((out_f,), in_f)
        return self

    def conv1d(self, name, in_c, out_c, k=1, bias=True):
        fan_in = in_c * k
        self.sd[f"{name}.weight"] = self._kaiming_uniform((out_c, in_c, k), fan_in)
        if bias:
            self.sd[f"{name}.bias"] = self._kaiming_uniform((out_c,), fan_in)
        return self

    def conv2d(self, name, in_c, out_c, k, groups=1, bias=True):
        kh, kw = (k, k) if isinstance(k, int) else k
        fan_in = (in_c // groups) * kh * kw
        self.sd[f"{name}.weight"] = self._kaiming_uniform(
            (out_c, in_c // groups, kh, kw), fan_in
        )
        if bias:
            self.sd[f"{name}.bias"] = self._kaiming_uniform((out_c,), fan_in)
        return self

    def layer_norm(self, name, dim):
        self.sd[f"{name}.weight"] = np.ones((dim,), np.float32)
        self.sd[f"{name}.bias"] = np.zeros((dim,), np.float32)
        return self

    group_norm = layer_norm

    def batch_norm(self, name, dim):
        self.sd[f"{name}.weight"] = np.ones((dim,), np.float32)
        self.sd[f"{name}.bias"] = np.zeros((dim,), np.float32)
        self.sd[f"{name}.running_mean"] = np.zeros((dim,), np.float32)
        self.sd[f"{name}.running_var"] = np.ones((dim,), np.float32)
        return self

    def lstm(self, name, input_size, hidden, bidirectional=True):
        """torch nn.LSTM(num_layers=1) params: all U(-1/sqrt(H), 1/sqrt(H))."""
        sufs = ("", "_reverse") if bidirectional else ("",)
        for suf in sufs:
            self.sd[f"{name}.weight_ih_l0{suf}"] = self._kaiming_uniform(
                (4 * hidden, input_size), hidden
            )
            self.sd[f"{name}.weight_hh_l0{suf}"] = self._kaiming_uniform(
                (4 * hidden, hidden), hidden
            )
            self.sd[f"{name}.bias_ih_l0{suf}"] = self._kaiming_uniform(
                (4 * hidden,), hidden
            )
            self.sd[f"{name}.bias_hh_l0{suf}"] = self._kaiming_uniform(
                (4 * hidden,), hidden
            )
        return self

    def const(self, name, shape, value):
        self.sd[name] = np.full(shape, value, dtype=np.float32)
        return self

    def trunc_normal_(self, name, shape, std=0.02):
        self.sd[name] = trunc_normal(self.rng, shape, std=std)
        return self

    def zeros(self, name, shape):
        self.sd[name] = np.zeros(shape, np.float32)
        return self

    def ones(self, name, shape):
        self.sd[name] = np.ones(shape, np.float32)
        return self
