"""jittor_mlp_tpu_torch — the PyTorch / CUDA port of jittor_mlp_tpu.

The JAX package ``jittor_mlp_tpu`` is the reference; this package mirrors its
module paths, factory signatures and torch ``state_dict`` names in PyTorch
for one NVIDIA H100. Every kernel the JAX package wrote in Pallas becomes a
kernel written by hand for Hopper (``csrc/``, bound in ``ops/kernels/``);
on a CPU tensor each kernel's wrapper runs its plain PyTorch twin.

This package imports neither JAX nor ``jittor_mlp_tpu``, and builds no kernel
at import time.
"""

from . import config
from .core.model import Model
from .models.active_mlp import ActiveBase, ActiveLarge, ActiveSmall
from .models.as_mlp import AS_MLP
from .models.conv_mixer import ConvMixer
from .models.conv_mlp import convmlp_l, convmlp_m, convmlp_s
from .models.cycle_mlp import CycleMLP_B1, CycleMLP_B2, CycleMLP_B3, CycleMLP_B4, CycleMLP_B5
from .models.dyna_mlp import DynaMixer
from .models.gfnet import GFNet, GFNetPyramid
from .models.g_mlp import gMLPForImageClassification
from .models.hire_mlp import HireMLP
from .models.mlp_mixer import MLPMixerForImageClassification
from .models.morph_mlp import MorphMLP
from .models.ms_mlp import MS_MLP
from .models.raft_mlp import RaftMLP
from .models.repmlpnet import create_RepMLPNet_B224, create_RepMLPNet_B256
from .models.res_mlp import ResMLPForImageClassification
from .models.s2_mlp_v1 import S2MLPv1_deep, S2MLPv1_wide
from .models.s2_mlp_v2 import S2MLPv2
from .models.sequencer import Sequencer2D
from .models.sparse_mlp import SparseMLP
from .models.swin_mlp import SwinMLP
from .models.vip import ViP
from .models.wave_mlp import WaveMLP
from .serving import MicroBatcher, Predictor

__all__ = [
    "AS_MLP",
    "ConvMixer",
    "ActiveBase",
    "ActiveLarge",
    "ActiveSmall",
    "CycleMLP_B1",
    "CycleMLP_B2",
    "CycleMLP_B3",
    "CycleMLP_B4",
    "CycleMLP_B5",
    "DynaMixer",
    "GFNet",
    "GFNetPyramid",
    "HireMLP",
    "MS_MLP",
    "Model",
    "MicroBatcher",
    "MorphMLP",
    "Predictor",
    "RaftMLP",
    "S2MLPv1_deep",
    "S2MLPv1_wide",
    "S2MLPv2",
    "Sequencer2D",
    "SparseMLP",
    "SwinMLP",
    "ViP",
    "WaveMLP",
    "config",
    "convmlp_l",
    "convmlp_m",
    "convmlp_s",
    "create_RepMLPNet_B224",
    "create_RepMLPNet_B256",
    "MLPMixerForImageClassification",
    "ResMLPForImageClassification",
    "gMLPForImageClassification",
]

__version__ = "0.4.0"
