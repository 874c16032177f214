"""ResMLP (Touvron et al., arXiv:2105.03404), plain float32, as the model
zoo this port follows executes it.

Per block, on tokens x (B, N, D), with Aff(v) = α ⊙ v + β:
    h = Aff1(x)
    h = h + γ1 ⊙ (W_t · h + b_t)                          (mixing over N)
    h = Aff2(h)
    x = h + γ2 ⊙ (GELU(h W_1ᵀ + c_1) W_2ᵀ + c_2)          (mixing over D)
after a Conv2d(k = s = patch) patch embedding; then the mean over tokens
and a linear head. Two departures from the paper, both the zoo's
(``res_mlp.py`` of the reference the port was written against): each
residual adds to the affine's output, not to the block's input, and the
final Aff (``affine``) is built but never applied. GELU is the exact erf
form. Parameters carry the torch reference's names.

Also the yardstick's counts: products per image and, per block launch, the
operations and the bytes a block needs from its shapes.
"""

from __future__ import annotations

import math

from .common import gelu, matmul, patch_embed


def _dims(cfg):
    n = (cfg["image_size"] // cfg["patch_size"]) ** 2
    return n, cfg["d_model"], cfg["d_model"] * cfg["expansion_factor"]


def param_specs(cfg, draw):
    """[(name, shape, mean, std)] of every parameter, as
    ``draw`` (the configuration's ``assumed.weights``) sets them."""
    n, d, f = _dims(cfg)
    c, p = cfg["in_channels"], cfg["patch_size"]
    bias, aw, ab = draw["bias_std"], draw["affine_alpha_std"], draw["affine_beta_std"]

    def dense(name, shape, fan_in):
        return [(f"{name}.weight", shape, 0.0, 1.0 / math.sqrt(fan_in)),
                (f"{name}.bias", (shape[0],), 0.0, bias)]

    def aff(name):
        return [(f"{name}.alpha", (1, 1, d), draw["affine_alpha_mean"], aw),
                (f"{name}.beta", (1, 1, d), 0.0, ab)]

    specs = dense("patcher.0", (d, c, p, p), c * p * p)
    for i in range(cfg["depth"]):
        b = f"model.{i}."
        specs += aff(b + "pre_affine")
        specs += dense(b + "token_mix", (n, n, 1), n)
        specs += dense(b + "ff.net.0", (f, d), d)
        specs += dense(b + "ff.net.3", (d, f), f)
        specs += aff(b + "post_affine")
        specs += [(b + "gamma_1", (d,), draw["gamma_mean"], draw["gamma_std"]),
                  (b + "gamma_2", (d,), draw["gamma_mean"], draw["gamma_std"])]
    specs += aff("affine")
    specs += dense("mlp_head.0", (cfg["num_classes"], d), d)
    return specs


def forward(w, x, mm=matmul):
    """Logits (B, classes) of NCHW float32 images ``x`` under weights
    ``w`` ({name: tensor}); ``mm`` is the dense product."""
    x = patch_embed(x, w["patcher.0.weight"], w["patcher.0.bias"],
                    w["patcher.0.weight"].shape[-1], mm)
    i = 0
    while f"model.{i}.token_mix.weight" in w:
        b = f"model.{i}."
        h = x * w[b + "pre_affine.alpha"].reshape(-1) + w[b + "pre_affine.beta"].reshape(-1)
        t = mm(h.transpose(1, 2), w[b + "token_mix.weight"][:, :, 0].t()) + w[b + "token_mix.bias"]
        h = h + w[b + "gamma_1"] * t.transpose(1, 2)
        h = h * w[b + "post_affine.alpha"].reshape(-1) + w[b + "post_affine.beta"].reshape(-1)
        y = gelu(mm(h, w[b + "ff.net.0.weight"].t()) + w[b + "ff.net.0.bias"])
        x = h + w[b + "gamma_2"] * (mm(y, w[b + "ff.net.3.weight"].t()) + w[b + "ff.net.3.bias"])
        i += 1
    return mm(x.mean(1), w["mlp_head.0.weight"].t()) + w["mlp_head.0.bias"]


def flops_per_image(cfg):
    """Products of one forward, 2·M·N·K each: patch embedding, the blocks'
    three products, the head."""
    n, d, f = _dims(cfg)
    patch = 2 * n * d * cfg["in_channels"] * cfg["patch_size"] ** 2
    return patch + cfg["depth"] * block_ops(cfg, 1) + 2 * d * cfg["num_classes"]


def block_ops(cfg, batch):
    """Operations of one block launch on ``batch`` images: the token
    product (2·N·N·D) and the two channel products (2·N·D·F each)."""
    n, d, f = _dims(cfg)
    return 2 * batch * n * d * (n + 2 * f)


def block_bytes(cfg, batch, act_bytes=2):
    """Bytes one block launch needs from memory: its input read once and its
    output written once, and every weight, bias, affine and γ vector read
    once, all in the served type (``act_bytes`` a value)."""
    n, d, f = _dims(cfg)
    weights = n * n + n + 2 * d * f + f + d + 6 * d
    return act_bytes * (2 * batch * n * d + weights)
