"""The models of the parallel-layer tests, shared by ``test_torch_parallel.py``
and ``test_torch_parallel_dist.py`` and by the gloo worlds those spawn
(``torch_parallel_worker.py``), which import neither JAX nor the JAX
package: each case names its factory by attribute path, which both
packages export, so that ``build(package, name)`` builds it in either, from
the same seed and so with the same weights.

``PP_CASES`` are ``tests/test_pp_zoo.py``'s: the 20 families whose blocks
the JAX ``scan_blocks`` reaches, at its sizes, stack depths divisible by
two pipeline stages ("PP_XS" settings of WaveMLP, Sequencer2D, MorphMLP
and DynaMixer, which ``add_pp_settings`` adds to a package's tables).
The others are ``tests/test_parallel_features.py``'s.
"""

import importlib

import numpy as np

PP_SETTINGS = {  # module: (table, PP_XS setting), as tests/test_pp_zoo.py sets them
    "wave_mlp": ("wavemlp_settings", [[2, 2, 2, 2], [2, 2, 2, 2]]),
    "sequencer": ("sequencer_settings", [[2, 2], [16, 32], [8, 8], 2]),
    "morph_mlp": ("morphmlp_settings", [[2, 2], [2, 2], [16, 32], [4, 4], [0.0, 0.0]]),
    "dyna_mlp": ("dynamlp_settings", [[4, 2], [16, 32], [2, 2], [2, 4], 2, 0.0, 2]),
}

PP_CASES = {  # name: (factory path, kwargs, image side)
    "vip": ("ViP", dict(image_size=32, patch_size=8, num_classes=10, d_model=32, depth=2,
                        segments=4, expansion_factor=2), 32),
    "s2_mlp_v1": ("models.s2_mlp_v1.S2MLPv1", dict(
        image_size=32, patch_size=[4, 2], num_classes=10, d_model=[32, 64], depth=[2, 2],
        expansion_factor=[2, 2]), 32),
    "s2_mlp_v2": ("S2MLPv2", dict(
        image_size=32, patch_size=[4, 2], num_classes=10, d_model=[32, 64], depth=[2, 2],
        expansion_factor=[2, 2]), 32),
    "conv_mixer": ("ConvMixer", dict(dim=32, depth=4, kernel_size=5, patch_size=4,
                                     n_classes=10), 32),
    "conv_mlp": ("models.conv_mlp.ConvMLP", dict(
        depth=[2, 2], d_model=[32, 64], expansion_factor=[2, 2], channels=16,
        n_conv_blocks=2, num_classes=10), 64),
    "sparse_mlp": ("SparseMLP", dict(image_size=32, patch_size=4, num_classes=10, d_model=16,
                                     depth=[2, 2], expansion_factor=2), 32),
    "hire_mlp": ("HireMLP", dict(
        patch_size=4, num_classes=10, d_model=[16, 32], h=[4, 3], w=[4, 3],
        cross_region_step=[2, 1], cross_region_interval=2, depth=[2, 2],
        expansion_factor=2), 32),
    "gfnet": ("GFNet", dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32,
                            depth=4), 32),
    "gfnet_pyramid": ("GFNetPyramid", dict(
        img_size=32, patch_size=4, num_classes=10, embed_dim=[16, 32, 48, 64],
        depth=[2, 2, 2, 2]), 32),
    "cycle_mlp": ("models.cycle_mlp.CycleNet", dict(
        layers=[2, 2], embed_dims=[16, 32], transitions=[True, True], mlp_ratios=[2, 2],
        num_classes=10), 32),
    "as_mlp": ("AS_MLP", dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                              depths=[2, 2], shift_size=3, drop_path_rate=0.0), 32),
    "ms_mlp": ("MS_MLP", dict(
        img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2], shift_size=3,
        shift_dist=[-1, 0, 1], mix_size=[[1, 3, 5], [1, 3, 3]], drop_path_rate=0.0), 32),
    "repmlpnet": ("models.repmlpnet.RepMLPNet", dict(
        in_channels=3, num_class=10, patch_size=(2, 2), num_blocks=(2, 2), channels=(8, 16),
        hs=(4, 2), ws=(4, 2), sharesets_nums=(2, 4), reparam_conv_k=(1, 3)), 16),
    "wave_mlp": ("WaveMLP", dict(model_name="PP_XS", num_classes=10), 64),
    "morph_mlp": ("MorphMLP", dict(model_name="PP_XS", num_classes=10), 32),
    "dyna_mlp": ("DynaMixer", dict(model_name="PP_XS", image_size=32, num_classes=10), 32),
    "sequencer": ("Sequencer2D", dict(model_name="PP_XS", num_classes=10), 28),
    "mlp_mixer": ("MLPMixerForImageClassification", dict(
        d_model=32, depth=4, patch_size=4, image_size=32, num_classes=10,
        expansion_factor=2), 32),
    "g_mlp": ("gMLPForImageClassification", dict(
        image_size=32, patch_size=4, d_model=32, d_ffn=64, depth=4, num_classes=10), 32),
    "res_mlp": ("ResMLPForImageClassification", dict(
        d_model=32, depth=4, patch_size=4, image_size=32, num_classes=10,
        expansion_factor=2), 32),
    "swin_mlp": ("SwinMLP", dict(
        img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[4, 4],
        num_heads=[2, 4], window_size=4, drop_path_rate=0.0), 32),
}

# tests/test_parallel_features.py's configurations (image side 16)
MIXER_KW = dict(d_model=32, depth=4, patch_size=4, image_size=16, num_classes=8,
                expansion_factor=2)
GMLP_KW = dict(image_size=16, patch_size=4, d_model=32, d_ffn=64, depth=4, num_classes=8)
RESMLP_KW = dict(image_size=16, patch_size=4, d_model=32, depth=4, num_classes=8,
                 expansion_factor=2)
ASMLP_KW = dict(img_size=16, patch_size=4, embed_dim=16, depths=[2, 2], shift_size=3,
                mlp_ratio=2.0, num_classes=8, drop_path_rate=0.0)
SWIN_DP_KW = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[4, 4],
                  num_heads=[2, 4], window_size=4, drop_path_rate=0.5)
SHARD_CASES = {  # test_shard_generalizes_across_families: (factory, kwargs), image side 32
    "wave_mlp": ("WaveMLP", dict(model_name="T", image_size=32)),
    "swin_mlp": ("SwinMLP", dict(img_size=32, patch_size=4, embed_dim=16, depths=[2, 2],
                                 num_heads=[2, 4], window_size=4, num_classes=8)),
    "cycle_mlp": ("CycleMLP_B1", dict(image_size=32, num_classes=8)),
}
FEATURE_CASES = {  # name: (factory path, kwargs, image side)
    "mixer": ("MLPMixerForImageClassification", MIXER_KW, 16),
    "gmlp": ("gMLPForImageClassification", GMLP_KW, 16),
    "asmlp": ("AS_MLP", ASMLP_KW, 16),
    "resmlp": ("ResMLPForImageClassification", RESMLP_KW, 16),
    "swin_dp": ("SwinMLP", SWIN_DP_KW, 32),
    "wave_xs": ("WaveMLP", dict(model_name="PP_XS", num_classes=8), 32),
    **{f"shard_{k}": (f, kw, 32) for k, (f, kw) in SHARD_CASES.items()},
}
ALL_CASES = {**PP_CASES, **FEATURE_CASES}


def add_pp_settings(package):
    """Add the "PP_XS" settings to ``package``'s tables (idempotent)."""
    for module, (table, setting) in PP_SETTINGS.items():
        getattr(importlib.import_module(f"{package}.models.{module}"), table)["PP_XS"] = setting


def factory(package, path):
    """The factory at attribute ``path`` of ``package``."""
    obj = importlib.import_module(package)
    for part in path.split("."):
        obj = getattr(obj, part) if hasattr(obj, part) else \
            importlib.import_module(f"{obj.__name__}.{part}")
    return obj


def build(package, name, **extra):
    """Case ``name`` built by ``package`` ("jittor_mlp_tpu" or
    "jittor_mlp_tpu_torch", which gets ``device="cpu"``)."""
    add_pp_settings(package)
    path, kwargs, _ = ALL_CASES[name]
    if package == "jittor_mlp_tpu_torch":
        extra = {"device": "cpu", **extra}
    return factory(package, path)(**kwargs, **extra)


def images(name, batch=8, seed=2):
    side = ALL_CASES[name][2]
    return np.random.default_rng(seed).standard_normal((batch, 3, side, side)).astype(
        np.float32)


def labels(batch=8, classes=8):
    return np.arange(batch) % classes
