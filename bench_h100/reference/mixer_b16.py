"""MLP-Mixer (Tolstikhin et al., arXiv:2105.01601), plain float32.

Per block, on tokens x (B, N, D):
    x = x + W_t2 · GELU(W_t1 · LN1(x) + b_t1) + b_t2      (mixing over N)
    x = x + GELU(LN2(x) W_c1ᵀ + b_c1) W_c2ᵀ + b_c2        (mixing over D)
after a Conv2d(k = s = patch) patch embedding; then a LayerNorm, the mean
over tokens and a linear head. GELU is the exact erf form. Parameters
carry the torch reference's names (``patcher.0``, ``model.{i}.0.norm``,
``model.{i}.0.fn.net.{0,3}`` as Conv1d weights (out, in, 1),
``model.{i}.1.…``, ``active``, ``mlp_head.0``).

Also the yardstick's counts: products per image and, per block launch, the
operations and the bytes a block needs from its shapes.
"""

from __future__ import annotations

import math

from .common import gelu, layer_norm, matmul, patch_embed


def _dims(cfg):
    n = (cfg["image_size"] // cfg["patch_size"]) ** 2
    return n, cfg["d_model"], cfg["token_dim"], cfg["d_model"] * cfg["expansion_factor"]


def param_specs(cfg, draw):
    """[(name, shape, mean, std)] of every parameter, as
    ``draw`` (the configuration's ``assumed.weights``) sets them."""
    n, d, ds, dc = _dims(cfg)
    c, p = cfg["in_channels"], cfg["patch_size"]
    bias, ln_w, ln_b = draw["bias_std"], draw["norm_weight_std"], draw["norm_bias_std"]

    def dense(name, shape, fan_in):
        return [(f"{name}.weight", shape, 0.0, 1.0 / math.sqrt(fan_in)),
                (f"{name}.bias", (shape[0],), 0.0, bias)]

    def norm(name):
        return [(f"{name}.weight", (d,), 1.0, ln_w), (f"{name}.bias", (d,), 0.0, ln_b)]

    specs = dense("patcher.0", (d, c, p, p), c * p * p)
    for i in range(cfg["depth"]):
        specs += norm(f"model.{i}.0.norm")
        specs += dense(f"model.{i}.0.fn.net.0", (ds, n, 1), n)
        specs += dense(f"model.{i}.0.fn.net.3", (n, ds, 1), ds)
        specs += norm(f"model.{i}.1.norm")
        specs += dense(f"model.{i}.1.fn.net.0", (dc, d), d)
        specs += dense(f"model.{i}.1.fn.net.3", (d, dc), dc)
    specs += norm("active")
    specs += dense("mlp_head.0", (cfg["num_classes"], d), d)
    return specs


def forward(w, x, mm=matmul):
    """Logits (B, classes) of NCHW float32 images ``x`` under weights
    ``w`` ({name: tensor}); ``mm`` is the dense product."""
    x = patch_embed(x, w["patcher.0.weight"], w["patcher.0.bias"],
                    w["patcher.0.weight"].shape[-1], mm)
    i = 0
    while f"model.{i}.0.norm.weight" in w:
        t, c = f"model.{i}.0.", f"model.{i}.1."
        y = layer_norm(x, w[t + "norm.weight"], w[t + "norm.bias"]).transpose(1, 2)  # (B, D, N)
        h = gelu(mm(y, w[t + "fn.net.0.weight"][:, :, 0].t()) + w[t + "fn.net.0.bias"])
        x = x + (mm(h, w[t + "fn.net.3.weight"][:, :, 0].t()) + w[t + "fn.net.3.bias"]).transpose(1, 2)
        y = layer_norm(x, w[c + "norm.weight"], w[c + "norm.bias"])
        h = gelu(mm(y, w[c + "fn.net.0.weight"].t()) + w[c + "fn.net.0.bias"])
        x = x + mm(h, w[c + "fn.net.3.weight"].t()) + w[c + "fn.net.3.bias"]
        i += 1
    x = layer_norm(x, w["active.weight"], w["active.bias"]).mean(1)
    return mm(x, w["mlp_head.0.weight"].t()) + w["mlp_head.0.bias"]


def flops_per_image(cfg):
    """Products of one forward, 2·M·N·K each: patch embedding, the blocks'
    four products, the head."""
    n, d, ds, dc = _dims(cfg)
    patch = 2 * n * d * cfg["in_channels"] * cfg["patch_size"] ** 2
    return patch + cfg["depth"] * block_ops(cfg, 1) + 2 * d * cfg["num_classes"]


def block_ops(cfg, batch):
    """Operations of one block launch on ``batch`` images: two token
    products (2·N·D·D_S each) and two channel products (2·N·D·D_C each)."""
    n, d, ds, dc = _dims(cfg)
    return 4 * batch * n * d * (ds + dc)


def block_bytes(cfg, batch, act_bytes=2):
    """Bytes one block launch needs from memory: its input read once and its
    output written once, and every weight, bias and LayerNorm vector read
    once, all in the served type (``act_bytes`` a value)."""
    n, d, ds, dc = _dims(cfg)
    weights = 2 * n * ds + 2 * d * dc + ds + n + dc + d + 4 * d
    return act_bytes * (2 * batch * n * d + weights)
