"""The port's ``deploy`` (``torch.export``) and its kernel ops, on the CPU.

Mirrors tests/test_deploy.py: the saved program reproduces the live
model's logits exactly and does not follow later edits of the model; the
exported shape is fixed; ``int8=True`` bakes the W8A8 path in (away from
float32, equal to the eager ``int8_mode()`` forward). Then the four block
kernel families in bf16: every block is one ``jittor_mlp_tpu_torch`` op node
(the AS-MLP shift two a block) and the program equals the eager forward.
Each of the seven serving-path kernel ops passes ``torch.library.opcheck``
on CPU inputs, and its CPU implementation equals its twin bit for bit.
(test_torch_deploy_zoo.py round-trips every family.)
"""

import contextlib

import numpy as np
import pytest
import torch

import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch import config, deploy
from jittor_mlp_tpu_torch.ops.kernels import (axial_shift, gmlp_block, gmlp_block_int8,
                                              mixer_block, mixer_block_int8, resmlp_block,
                                              resmlp_block_int8)

MIXER = dict(image_size=16, patch_size=4, d_model=32, depth=2, num_classes=8)


def _x(shape=(4, 3, 16, 16), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _program_ops(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("jittor_mlp_tpu_torch.")]


def test_export_roundtrip_exact(tmp_path):
    model = jt.MLPMixerForImageClassification(**MIXER, use_pallas=False, device="cpu")
    x = _x()
    with torch.inference_mode():
        want = model.eval().forward(x)
    path = deploy.save_exported(model, str(tmp_path / "m.pt2"), batch_size=4, image_size=16)
    fwd = deploy.load_exported(path)
    got = fwd(x.numpy())
    assert torch.equal(got, want)
    # the file is self-contained: editing the live model does not reach it
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    assert torch.equal(deploy.load_exported(path)(x), want)


def test_export_shape_is_fixed(tmp_path):
    model = jt.MLPMixerForImageClassification(**MIXER, device="cpu")
    path = deploy.save_exported(model, str(tmp_path / "m.pt2"), batch_size=4, image_size=16)
    fwd = deploy.load_exported(path)
    assert deploy.input_spec(fwd.program) == ((4, 3, 16, 16), torch.float32,
                                              torch.device("cpu"))
    with pytest.raises(Exception):
        fwd(_x((3, 3, 16, 16)))
    with pytest.raises(Exception):
        fwd.program.module()(_x((3, 3, 16, 16)))  # the program's own guard


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_export_int8_bakes_quantized_path(dtype, tmp_path):
    model = jt.MLPMixerForImageClassification(**MIXER, device="cpu").to(dtype)
    x = _x().to(dtype)
    path = deploy.save_exported(model, str(tmp_path / "q.pt2"), batch_size=4, image_size=16,
                                dtype=dtype, int8=True)
    got = deploy.load_exported(path)(x)
    with torch.inference_mode():
        exact = model.eval().forward(x)
        with config.int8_mode():
            want = model.forward(x)
    assert torch.equal(got, want)
    assert not torch.equal(got, exact)
    assert ("jittor_mlp_tpu_torch.fused_mixer_block_int8.default" in
            _program_ops(deploy.load_exported(path).program)) == (dtype == torch.bfloat16)


KERNEL_FAMILIES = {  # name: (factory, kwargs, op, op nodes per forward)
    "mlp_mixer": (jt.MLPMixerForImageClassification, MIXER, "fused_mixer_block", 2),
    "res_mlp": (jt.ResMLPForImageClassification,
                dict(d_model=32, num_classes=8, patch_size=4, image_size=16, depth=2),
                "fused_resmlp_block", 2),
    "g_mlp": (jt.gMLPForImageClassification,
              dict(d_model=32, d_ffn=64, num_classes=8, patch_size=4, image_size=16, depth=2),
              "fused_gmlp_block", 2),
    "as_mlp": (jt.AS_MLP, dict(img_size=16, patch_size=4, num_classes=8, embed_dim=16,
                               depths=[1, 1], shift_size=3), "axial_shift", 4),
}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", list(KERNEL_FAMILIES))
def test_bf16_program_runs_the_block_ops(name, int8, tmp_path):
    factory, kw, op, per_forward = KERNEL_FAMILIES[name]
    model = factory(**kw, device="cpu").to_bf16()
    x = _x().bfloat16()
    path = deploy.save_exported(model, str(tmp_path / "b.pt2"), batch_size=4, image_size=16,
                                dtype=torch.bfloat16, int8=int8)
    fwd = deploy.load_exported(path)
    want_op = f"jittor_mlp_tpu_torch.{op}{'_int8' if int8 and op != 'axial_shift' else ''}"
    assert _program_ops(fwd.program) == [f"{want_op}.default"] * per_forward
    with torch.inference_mode(), config.int8_mode() if int8 else contextlib.nullcontext():
        want = model.eval().forward(x)
    assert torch.equal(fwd(x), want)


def _block_weights(g, B, N, D, TD, CD):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16()

    x = rn(B, N, D)
    return x, [1 + rn(D, scale=0.1), rn(D, scale=0.1), rn(TD, N, scale=N ** -0.5), rn(TD),
               rn(N, TD, scale=TD ** -0.5), rn(N), 1 + rn(D, scale=0.1), rn(D, scale=0.1),
               rn(CD, D, scale=D ** -0.5), rn(CD), rn(D, CD, scale=CD ** -0.5), rn(D)]


def _resmlp_weights(g, B, N, D, F):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16()

    x = rn(B, N, D)
    return x, [1 + rn(D, scale=0.1), rn(D, scale=0.1), rn(D, scale=0.1), rn(N, N, scale=N ** -0.5),
               rn(N), 1 + rn(D, scale=0.1), rn(D, scale=0.1), rn(D, scale=0.1),
               rn(F, D, scale=D ** -0.5), rn(F), rn(D, F, scale=F ** -0.5), rn(D)]


def _gmlp_weights(g, B, N, D, F):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16()

    x = rn(B, N, D)
    return x, [1 + rn(D, scale=0.1), rn(D, scale=0.1), rn(2 * F, D, scale=D ** -0.5), rn(2 * F),
               1 + rn(F, scale=0.1), rn(F, scale=0.1), rn(N, N, scale=N ** -0.5), rn(N),
               rn(D, F, scale=F ** -0.5), rn(D)]


def _op_cases():
    g = torch.Generator().manual_seed(0)
    mixer = _block_weights(g, 2, 8, 16, 8, 32)
    res = _resmlp_weights(g, 2, 8, 16, 32)
    gm = _gmlp_weights(g, 2, 8, 16, 32)
    shift_x = torch.randn(2, 6, 5, 8, generator=g).bfloat16()
    return {  # op name: (module, twin, args)
        "fused_mixer_block": (mixer_block, "mixer_block_ref", (mixer[0], *mixer[1])),
        "fused_mixer_block_int8": (mixer_block_int8, "mixer_block_int8_ref",
                                   (mixer[0], *mixer[1])),
        "fused_resmlp_block": (resmlp_block, "resmlp_block_ref", (res[0], *res[1])),
        "fused_resmlp_block_int8": (resmlp_block_int8, "resmlp_block_int8_ref",
                                    (res[0], *res[1])),
        "fused_gmlp_block": (gmlp_block, "gmlp_block_ref", (gm[0], *gm[1])),
        "fused_gmlp_block_int8": (gmlp_block_int8, "gmlp_block_int8_ref", (gm[0], *gm[1])),
        "axial_shift": (axial_shift, "axial_shift_ref", (shift_x, 3, 2, -1)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_kernel_op_passes_opcheck_and_equals_its_twin(name):
    mod, twin, args = _op_cases()[name]
    op = getattr(torch.ops.jittor_mlp_tpu_torch, name).default
    assert mod.OP.default is op
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    before = mod.LAUNCHES
    got = op(*args)
    assert mod.LAUNCHES == before  # the CPU implementation launches nothing
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert torch.equal(got, getattr(mod, twin)(*args))


def test_fake_cuda_tensors_reach_the_op_not_a_launch():
    """Fake tensors on a CUDA device (what ``torch.export`` traces the card's
    model with) pass the wrappers' checks and reach the ops' fake
    implementations: nothing launches, nothing reads ``data_ptr``."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    mode = FakeTensorMode()

    def fake(shape):
        return FakeTensor(mode, torch.empty(shape, dtype=torch.bfloat16, device="meta"),
                          torch.device("cuda", 0))

    _, _, args = _op_cases()["fused_mixer_block"]
    with mode:
        out = mixer_block.fused_mixer_block(*(fake(a.shape) for a in args))
        shifted = axial_shift.shift(fake((2, 6, 5, 8)), 3, 1)
    assert out.device == shifted.device == torch.device("cuda", 0)
    assert out.shape == args[0].shape and shifted.shape == (2, 6, 5, 8)
    assert mixer_block.LAUNCHES == 0 and axial_shift.LAUNCHES == 0
