"""The port imports without JAX, nvcc or triton, and builds nothing on import."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax_and_needs_no_toolchain():
    code = (
        "import sys\n"
        "import jittor_mlp_tpu_torch as jt\n"
        "import jittor_mlp_tpu_torch.quant\n"
        "import jittor_mlp_tpu_torch.examples.train\n"
        "import jittor_mlp_tpu_torch.parallel\n"
        "import jittor_mlp_tpu_torch.tools.profile_blocks\n"
        "import jittor_mlp_tpu_torch.tools.kernel_lab\n"
        "from jittor_mlp_tpu_torch.models import (\n"
        "    dyna_mlp, raft_mlp, s2_mlp_v1, s2_mlp_v2, swin_mlp, vip)\n"
        "from jittor_mlp_tpu_torch.models import active_mlp, cycle_mlp, hire_mlp, ms_mlp\n"
        "from jittor_mlp_tpu_torch.ops import deform, shift, window\n"
        "from jittor_mlp_tpu_torch.ops.kernels import (\n"
        "    axial_shift, gemm_sm90, gmlp_block, gmlp_block_int8, kernel_lab, mixer_block,\n"
        "    mixer_block_bwd, mixer_block_int8, resmlp_block, resmlp_block_int8)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'jittor_mlp_tpu' not in sys.modules, 'JAX package imported'\n"
        "assert 'triton' not in sys.modules, 'triton imported'\n"
        "assert hasattr(jt, 'gMLPForImageClassification') and hasattr(jt, 'AS_MLP')\n"
        "for f in ('ViP', 'S2MLPv1_deep', 'S2MLPv1_wide', 'S2MLPv2', 'RaftMLP', 'SwinMLP',\n"
        "          'DynaMixer', 'MS_MLP', 'HireMLP', 'CycleMLP_B1', 'CycleMLP_B2',\n"
        "          'CycleMLP_B3', 'CycleMLP_B4', 'CycleMLP_B5', 'ActiveSmall', 'ActiveBase',\n"
        "          'ActiveLarge'):\n"
        "    assert hasattr(jt, f), f\n"
        "assert callable(cycle_mlp.CycleNet) and callable(active_mlp.ActivexTiny)\n"
        "for m in (axial_shift, gemm_sm90, gmlp_block, gmlp_block_int8, mixer_block,\n"
        "          mixer_block_bwd, mixer_block_int8, resmlp_block, resmlp_block_int8):\n"
        "    assert not m._LIB.loaded, f'{m.__name__}: kernel library loaded at import'\n"
        "assert not any(lib.loaded for lib in kernel_lab._LIBS.values()), 'lab library loaded'\n"
        "print('ok')\n"
    )
    # an empty PATH: no nvcc can be found, and the import must not need one
    env = {**os.environ, "PATH": "", "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
