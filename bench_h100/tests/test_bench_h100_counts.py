"""The yardstick's counts and references against the port, at small widths
on the CPU: each configuration's products per image equal the port's
``Model.flops``, a block launch's operations equal the port's
``block_flops``, and the plain float32 forward equals the port's float32
forward on the same weights."""

import os

import pytest
import torch

from bench_h100 import harness
from bench_h100.reference import common

import bench_small

program = pytest.importorskip("jittor_mlp_tpu_torch")
HERE = os.path.join(harness.ROOT, "bench_h100")
# (reference, factory, small arguments, weight draw) of each configuration
CASES = {}
for _c in harness.load_json(harness.ROOT, "BENCHMARK.json")["configs"]:
    _cfg = harness.load_json(harness.ROOT, _c["file"])
    CASES[_c["name"]] = (_cfg["reference"], _cfg["factory"], bench_small.ARGS[_c["name"]],
                         _cfg["assumed"]["weights"])
SHAPES = [dict(), dict(image_size=48, patch_size=16, depth=3)]


def _case(name, **args):
    ref, factory, small, draw = CASES[name]
    return harness.load_module(HERE, "reference", ref), factory, dict(small, **args), draw


@pytest.mark.parametrize("config", sorted(CASES))
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_flops_equal_the_ports(config, shape):
    ref, factory, args, _ = _case(config, **SHAPES[shape])
    s = args["image_size"]
    model = getattr(program, factory)(**args, device="cpu")
    assert ref.flops_per_image(args) == model.flops((1, 3, s, s))


@pytest.mark.parametrize("config", sorted(CASES))
def test_block_ops_equal_the_ports_formula(config):
    from jittor_mlp_tpu_torch.ops.kernels import mixer_block, resmlp_block

    ref, _, a, _ = _case(config)
    b = 6
    n = (a["image_size"] // a["patch_size"]) ** 2
    d = a["d_model"]
    x = (b, n, d)
    if config == "mixer_b16":
        port = mixer_block.block_flops(x, None, None, (a["token_dim"], n), None, None, None,
                                       None, None, (d * a["expansion_factor"], d))
    else:
        port = resmlp_block.block_flops(x, None, None, None, (n, n), None, None, None, None,
                                        (d * a["expansion_factor"], d))
    assert ref.block_ops(a, b) == port


@pytest.mark.parametrize("config", sorted(CASES))
def test_reference_forward_equals_the_ports_float32(config):
    ref, factory, args, draw = _case(config)
    w = common.draw_weights(ref.param_specs(args, draw), 123, "cpu")
    model = getattr(program, factory)(**args, device="cpu").eval()
    model.load_state_dict(w, strict=True)
    g = torch.Generator().manual_seed(5)
    x = common.preprocess(torch.randint(0, 256, (4, 32, 32, 3), generator=g, dtype=torch.uint8))
    with torch.no_grad():
        mine = ref.forward(w, x)
        port = model.forward(x)
    assert torch.allclose(mine, port, rtol=1e-4, atol=1e-4), (mine - port).abs().max()
    assert mine.std() > 0.05, "the weight draw keeps the logits apart"


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    ref, _, args, draw = _case("mixer_b16")
    specs = ref.param_specs(args, draw)
    a = common.draw_weights(specs, 2**33 + 1, "cpu")
    b = common.draw_weights(specs, 2**33 + 1, "cpu")
    d = common.draw_weights(specs, 2**33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mlp_head.0.weight"], d["mlp_head.0.weight"])


def test_weights_keep_their_draw():
    """Each leaf is its spec's mean plus its spec's spread, over one draw."""
    ref, _, args, draw = _case("mixer_b16")
    w = common.draw_weights(ref.param_specs(args, draw), 2**33 + 9, "cpu")
    head = w["mlp_head.0.weight"]
    assert abs(float(head.std()) * args["d_model"] ** 0.5 - 1.0) < 0.1
    gain = w["model.0.1.norm.weight"]
    assert abs(float(gain.mean()) - 1.0) < 0.05
    assert abs(float(gain.std()) - draw["norm_weight_std"]) < 0.03
