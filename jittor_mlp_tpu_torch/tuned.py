"""Measured best-known train/serve settings per zoo model, for the port (GENERATED).

Regenerate with ``python -m jittor_mlp_tpu_torch.tools.gen_tuned`` after
updating ``jittor_mlp_tpu_torch/sweeps/train_h100.jsonl`` or
``serving_h100.jsonl`` (``python -m jittor_mlp_tpu_torch.tools.compare``);
do not edit the tables by hand.

Every row was measured on
NVIDIA H100 80GB HBM3 at 700.00 W,
at the full widths of the harness's CONFIGS, with seed-0 weights.

``TRAIN``: bf16 mixed-precision training (f32 master weights, AdamW) through
``parallel.train.make_train_step``:
- ``remat``: whether checkpointing every block (``config.remat_mode()``)
  gave more img/s than the plain backward (or the plain step did not fit);
- ``batch``: the batch the number was measured at;
- ``img_s``: that training throughput, for provenance.

``SERVE``: the serving dtype, by the JAX package's rule on the serving
sweep: "f32" where bf16's top-1 agreement with the f32 forward is below
0.90 (64 images); "int8" (dynamic W8A8) where it is at least 1.05x the
bf16 img/s and keeps at least 0.98 agreement with bf16; "bf16" otherwise.
The img/s (b256) and agreements are the measurements behind each row.

``Predictor`` resolves its default serving dtype through
``serve_settings(name)``; pass ``bf16=``/``compute=`` to override.
``train_settings(name)`` / ``serve_settings(name)`` resolve either a sweep
key ("mlp_mixer") or a factory name ("MLPMixerForImageClassification") and
return None for a model without a row.
"""

TRAIN = {
    "active_mlp": {"factory": "ActivexTiny", "remat": False, "batch": 32, "img_s": 323.1},
    "as_mlp": {"factory": "AS_MLP", "remat": False, "batch": 32, "img_s": 326.5},
    "conv_mixer": {"factory": "ConvMixer", "remat": False, "batch": 32, "img_s": 111.2},
    "conv_mlp": {"factory": "convmlp_m", "remat": False, "batch": 32, "img_s": 387.5},
    "cycle_mlp": {"factory": "CycleMLP_B2", "remat": False, "batch": 32, "img_s": 194.9},
    "dyna_mlp": {"factory": "DynaMixer", "remat": False, "batch": 32, "img_s": 166.9},
    "g_mlp": {"factory": "gMLPForImageClassification", "remat": False, "batch": 32, "img_s": 233.3},
    "gfnet": {"factory": "GFNet", "remat": False, "batch": 32, "img_s": 612.8},
    "gfnet_h_b": {"factory": "GFNetPyramid", "remat": False, "batch": 32, "img_s": 236.8},
    "hire_mlp": {"factory": "HireMLP", "remat": False, "batch": 32, "img_s": 124.5},
    "mlp_mixer": {"factory": "MLPMixerForImageClassification", "remat": False, "batch": 32, "img_s": 361.2},
    "morph_mlp": {"factory": "MorphMLP", "remat": False, "batch": 32, "img_s": 253.7},
    "ms_mlp": {"factory": "MS_MLP", "remat": False, "batch": 32, "img_s": 321.4},
    "raft_mlp": {"factory": "RaftMLP", "remat": False, "batch": 32, "img_s": 1048.3},
    "repmlpnet": {"factory": "create_RepMLPNet_B224", "remat": False, "batch": 32, "img_s": 177.1},
    "res_mlp": {"factory": "ResMLPForImageClassification", "remat": False, "batch": 32, "img_s": 345.2},
    "s2_mlp_v1": {"factory": "S2MLPv1_wide", "remat": False, "batch": 32, "img_s": 633.9},
    "s2_mlp_v2": {"factory": "S2MLPv2", "remat": False, "batch": 32, "img_s": 421.2},
    "sequencer": {"factory": "Sequencer2D", "remat": False, "batch": 32, "img_s": 170.7},
    "sparse_mlp": {"factory": "SparseMLP", "remat": False, "batch": 32, "img_s": 138.9},
    "swin_mlp": {"factory": "SwinMLP", "remat": False, "batch": 32, "img_s": 665.8},
    "vip": {"factory": "ViP", "remat": False, "batch": 32, "img_s": 161.3},
    "wave_mlp": {"factory": "WaveMLP", "remat": False, "batch": 32, "img_s": 251.1},
}

SERVE = {
    "active_mlp": {"factory": "ActivexTiny", "dtype": "bf16", "bf16_img_s": 2655.8, "int8_img_s": 1441.4, "bf16_argmax": 1.0, "int8_argmax": 1.0},
    "as_mlp": {"factory": "AS_MLP", "dtype": "bf16", "bf16_img_s": 1695.9, "int8_img_s": 912.6, "bf16_argmax": 0.9844, "int8_argmax": 0.9688},
    "conv_mixer": {"factory": "ConvMixer", "dtype": "f32", "bf16_img_s": 410.0, "int8_img_s": 270.0, "bf16_argmax": 0.5312, "int8_argmax": 0.4844},
    "conv_mlp": {"factory": "convmlp_m", "dtype": "bf16", "bf16_img_s": 3251.8, "int8_img_s": 1502.9, "bf16_argmax": 0.9219, "int8_argmax": 0.9219},
    "cycle_mlp": {"factory": "CycleMLP_B2", "dtype": "bf16", "bf16_img_s": 2336.5, "int8_img_s": 1038.2, "bf16_argmax": 0.9844, "int8_argmax": 0.9531},
    "dyna_mlp": {"factory": "DynaMixer", "dtype": "bf16", "bf16_img_s": 1863.2, "int8_img_s": 744.3, "bf16_argmax": 0.9844, "int8_argmax": 0.9531},
    "g_mlp": {"factory": "gMLPForImageClassification", "dtype": "bf16", "bf16_img_s": 8162.8, "int8_img_s": 4151.9, "bf16_argmax": 0.9688, "int8_argmax": 0.9531},
    "gfnet": {"factory": "GFNet", "dtype": "bf16", "bf16_img_s": 2007.6, "int8_img_s": 865.7, "bf16_argmax": 0.9219, "int8_argmax": 0.9375},
    "gfnet_h_b": {"factory": "GFNetPyramid", "dtype": "bf16", "bf16_img_s": 1049.6, "int8_img_s": 573.7, "bf16_argmax": 0.9844, "int8_argmax": 0.9688},
    "hire_mlp": {"factory": "HireMLP", "dtype": "bf16", "bf16_img_s": 1469.7, "int8_img_s": 803.9, "bf16_argmax": 0.9531, "int8_argmax": 0.9375},
    "mlp_mixer": {"factory": "MLPMixerForImageClassification", "dtype": "bf16", "bf16_img_s": 8038.3, "int8_img_s": 5916.9, "bf16_argmax": 1.0, "int8_argmax": 0.9844},
    "morph_mlp": {"factory": "MorphMLP", "dtype": "bf16", "bf16_img_s": 2151.5, "int8_img_s": 826.9, "bf16_argmax": 0.9688, "int8_argmax": 0.9375},
    "ms_mlp": {"factory": "MS_MLP", "dtype": "bf16", "bf16_img_s": 2837.0, "int8_img_s": 1531.9, "bf16_argmax": 0.9844, "int8_argmax": 0.9688},
    "raft_mlp": {"factory": "RaftMLP", "dtype": "bf16", "bf16_img_s": 3704.5, "int8_img_s": 2065.6, "bf16_argmax": 0.9688, "int8_argmax": 0.875},
    "repmlpnet": {"factory": "create_RepMLPNet_B224", "dtype": "bf16", "bf16_img_s": 1954.8, "int8_img_s": 884.6, "bf16_argmax": 0.9219, "int8_argmax": 0.8906},
    "res_mlp": {"factory": "ResMLPForImageClassification", "dtype": "bf16", "bf16_img_s": 19462.4, "int8_img_s": 9480.2, "bf16_argmax": 1.0, "int8_argmax": 0.9844},
    "s2_mlp_v1": {"factory": "S2MLPv1_wide", "dtype": "bf16", "bf16_img_s": 2020.0, "int8_img_s": 771.9, "bf16_argmax": 1.0, "int8_argmax": 1.0},
    "s2_mlp_v2": {"factory": "S2MLPv2", "dtype": "f32", "bf16_img_s": 1984.8, "int8_img_s": 871.4, "bf16_argmax": 0.6562, "int8_argmax": 0.5},
    "sequencer": {"factory": "Sequencer2D", "dtype": "bf16", "bf16_img_s": 2022.5, "int8_img_s": 1028.4, "bf16_argmax": 0.9844, "int8_argmax": 1.0},
    "sparse_mlp": {"factory": "SparseMLP", "dtype": "bf16", "bf16_img_s": 1414.4, "int8_img_s": 576.7, "bf16_argmax": 1.0, "int8_argmax": 0.9844},
    "swin_mlp": {"factory": "SwinMLP", "dtype": "bf16", "bf16_img_s": 2681.7, "int8_img_s": 1482.6, "bf16_argmax": 0.9844, "int8_argmax": 0.9375},
    "vip": {"factory": "ViP", "dtype": "bf16", "bf16_img_s": 1865.5, "int8_img_s": 924.3, "bf16_argmax": 0.9844, "int8_argmax": 0.9531},
    "wave_mlp": {"factory": "WaveMLP", "dtype": "bf16", "bf16_img_s": 2444.3, "int8_img_s": 1118.7, "bf16_argmax": 0.9531, "int8_argmax": 0.9375},
}


def train_settings(name):
    """Best-known train settings for ``name`` (keys ``factory, remat,
    batch, img_s``), or None."""
    by_factory = {rec["factory"]: rec for rec in TRAIN.values()}
    return TRAIN.get(name) or by_factory.get(name)


def serve_settings(name):
    """Serving recommendation for ``name`` (``dtype`` "bf16"/"int8"/"f32"
    plus the measurements behind it), or None."""
    by_factory = {rec["factory"]: rec for rec in SERVE.values()}
    return SERVE.get(name) or by_factory.get(name)
