"""The port's gMLP-block twins against the Pallas kernels they replace.

``gmlp_block_ref`` and ``gmlp_block_int8_ref`` are the plain PyTorch twins
of the two CUDA kernels. Here they are held against
``jittor_mlp_tpu.ops.pallas.gmlp_block.fused_gmlp_block`` and
``gmlp_block_int8.fused_gmlp_block_int8``, run in Pallas interpret mode on
the CPU, on the same seeded numpy inputs (1/sqrt(fan_in) weights, std-0.5
biases, LayerNorm affines near 1, spatial bias near 1): the bf16 twin in
float32 within 1e-5 and in bf16 within 1.6e-2 of max(1, max|want|); the
W8A8 twin within 1.6e-2 of max(1, max|want|) in float32 and bf16. Both
twins run their products through the GEMM core's twins on the kernels'
layouts; written with whole products instead, each block is the same bit
for bit. The kernels themselves run only on the card (chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.gmlp_block as jg
import jittor_mlp_tpu.ops.pallas.gmlp_block_int8 as jgq
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block as tg
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block_int8 as tgq

SHAPES = {"small": (2, 20, 32, 48), "ragged": (4, 13, 24, 40)}


def _inputs(B, N, D, F, seed=0):
    r = np.random.default_rng(seed)

    def v(n, scale, mean=0.0):
        return (mean + scale * r.standard_normal(n)).astype(np.float32)

    def lin(out, fan_in, bias_mean=0.0):
        return ((r.standard_normal((out, fan_in)) / np.sqrt(fan_in)).astype(np.float32),
                v(out, 0.5, bias_mean))

    x = r.standard_normal((B, N, D)).astype(np.float32)
    ln1 = (v(D, 0.1, 1.0), v(D, 0.1))
    w1 = lin(2 * F, D)
    ln2 = (v(F, 0.1, 1.0), v(F, 0.1))
    wsp = lin(N, N, bias_mean=1.0)
    return x, (*ln1, *w1, *ln2, *wsp, *lin(D, F))


def _pallas_interpret(fn, x, weights, dtype):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = fn(jnp.asarray(x, dtype), *(jnp.asarray(w, dtype) for w in weights), bt=2)
    finally:
        pl.pallas_call = orig
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_ref_matches_pallas_kernel(shape, dtype):
    x, weights = _inputs(*SHAPES[shape])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _pallas_interpret(jg.fused_gmlp_block, x, weights, jdt)
    got = tg.gmlp_block_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_int8_ref_matches_pallas_kernel(shape, dtype):
    x, weights = _inputs(*SHAPES[shape], seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _pallas_interpret(jgq.fused_gmlp_block_int8, x, weights, jdt)
    got = tgq.gmlp_block_int8_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def test_int8_block_differs_from_bf16_block():
    x, weights = _inputs(*SHAPES["small"], seed=2)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    q = tgq.gmlp_block_int8_ref(tx, *tw).float()
    b = tg.gmlp_block_ref(tx, *tw).float()
    err = (q - b).abs().max().item()
    assert 0 < err <= 0.1 * max(1.0, b.abs().max().item()), err


def test_gate_reads_both_halves_of_y():
    """The block depends on the u half (gate) and on the v half (through the
    spatial product): zeroing W1's rows of either half changes the output."""
    x, weights = _inputs(*SHAPES["small"], seed=4)
    tx, tw = _torch(x, torch.float32), [_torch(w, torch.float32) for w in weights]
    F = tw[2].shape[0] // 2
    base = tg.gmlp_block_ref(tx, *tw)
    for half in (slice(0, F), slice(F, 2 * F)):
        w1 = tw[2].clone()
        w1[half] = 0
        moved = tg.gmlp_block_ref(tx, *tw[:2], w1, *tw[3:])
        assert (moved - base).abs().max().item() > 1e-2


@pytest.mark.parametrize("mod,fn,ref", [
    (tg, "fused_gmlp_block", "gmlp_block_ref"),
    (tgq, "fused_gmlp_block_int8", "gmlp_block_int8_ref"),
], ids=["bf16", "int8"])
def test_cpu_wrapper_runs_twin_without_launch(mod, fn, ref):
    x, weights = _inputs(*SHAPES["small"], seed=3)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    before = mod.LAUNCHES
    got = getattr(mod, fn)(tx, *tw)
    assert mod.LAUNCHES == before == 0
    assert torch.equal(got, getattr(mod, ref)(tx, *tw))


@pytest.mark.parametrize("fn", [tg.fused_gmlp_block, tgq.fused_gmlp_block_int8],
                         ids=["bf16", "int8"])
def test_wrapper_rejects_bad_inputs(fn):
    x, weights = _inputs(*SHAPES["small"])
    tw = [_torch(w, torch.float32) for w in weights]
    with pytest.raises(ValueError):
        fn(_torch(x, torch.float32)[0], *tw)  # not 3-D
    with pytest.raises(ValueError):
        bad = list(tw)
        bad[6] = bad[6][:, :-1]  # spatial weight with the wrong token count
        fn(_torch(x, torch.float32), *bad)
    with pytest.raises(ValueError):
        bad = list(tw)
        bad[2] = bad[2][:-1]  # W1 with an odd number of rows: no u, v split
        fn(_torch(x, torch.float32), *bad)
    with pytest.raises(TypeError):
        fn(torch.zeros(x.shape, dtype=torch.int32), *tw)
    with pytest.raises(ValueError):  # weights on another device than x
        fn(_torch(x, torch.float32).to("meta"), *tw)


def _int8_block_by_whole_products(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """The W8A8 block written with whole exact integer products and the
    scales applied as (acc · row scale) · column scale, per image for the
    token product: the formulation the twin had before it was built from the
    s8 core's twin."""
    from jittor_mlp_tpu_torch.ops.kernels.mixer_block import layer_norm_f32
    from jittor_mlp_tpu_torch.quant import exact_int_matmul, quant_act, quant_weight
    from jittor_mlp_tpu_torch.core.nnf import gelu_tanh
    B, N, D = x.shape
    F = w1.shape[0] // 2
    qw1, sw1 = quant_weight(w1, 1)
    qwsp, swsp = quant_weight(wsp, 1)
    qw2, sw2 = quant_weight(w2, 1)
    qxn, sxn = quant_act(layer_norm_f32(x, ln1w, ln1b).reshape(B * N, D), 1)
    y = gelu_tanh(exact_int_matmul(qxn, qw1.t()) * sxn * sw1.t() + b1.float())
    u, v = y[:, :F], y[:, F:]
    qv, sv = quant_act(layer_norm_f32(v, sgu_w, sgu_b).reshape(B, N, F), 1)
    v2 = torch.stack([exact_int_matmul(qwsp, qv[i]) * swsp * sv[i] for i in range(B)])
    g = u * (v2 + bs.float()[:, None]).reshape(B * N, F)
    qg, sg = quant_act(g, 1)
    h = exact_int_matmul(qg, qw2.t()) * sg * sw2.t() + b2.float()
    return (x.float().reshape(B * N, D) + h).reshape(B, N, D).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_int8_ref_built_from_the_s8_core_twin_keeps_its_rounding(shape, dtype):
    """gmlp_block_int8_ref runs its three products through gemm_s8_ref (the
    token product batched per image with qWsp shared, as the kernel runs it
    on the s8 wgmma core): bit for bit the block written with whole
    products, so every rounding point stayed where it was."""
    x, weights = _inputs(*SHAPES[shape], seed=5)
    tdt = getattr(torch, dtype)
    args = [_torch(a, tdt) for a in (x, *weights)]
    assert torch.equal(tgq.gmlp_block_int8_ref(*args), _int8_block_by_whole_products(*args))


def _block_by_whole_products(x, ln1w, ln1b, w1, b1, sgu_w, sgu_b, wsp, bs, w2, b2):
    """The bf16 block written with whole f32 products on the (B, N, ·)
    tensors, the token product as one matmul broadcast over the images: the
    formulation the twin had before it was built from the bf16 core's twin."""
    from jittor_mlp_tpu_torch.core.nnf import gelu_erf, gelu_tanh
    from jittor_mlp_tpu_torch.ops.kernels.mixer_block import layer_norm_f32
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    F = w1.shape[0] // 2
    xn = layer_norm_f32(x, ln1w, ln1b).to(dt)
    y = act(torch.matmul(xn.float(), w1.float().t()) + b1.float()).to(dt)
    u, v = y[..., :F], y[..., F:]
    vn = layer_norm_f32(v, sgu_w, sgu_b).to(dt)
    v2 = (torch.matmul(wsp.float(), vn.float()) + bs.float()[:, None]).to(dt)
    g = (u.float() * v2.float()).to(dt)
    return (x.float() + (torch.matmul(g.float(), w2.float().t()) + b2.float())).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_ref_built_from_the_bf16_core_twin_keeps_its_rounding(shape, dtype):
    """gmlp_block_ref runs its three products through gemm_bf16_ref on the
    kernel's layouts (Wsp copied into rows of Np = round_up(N, 8) and read
    as its first N columns, shared; vn an N-major B operand an entry an
    image): bit for bit the block written with whole products."""
    x, weights = _inputs(*SHAPES[shape], seed=7)
    tdt = getattr(torch, dtype)
    args = [_torch(a, tdt) for a in (x, *weights)]
    assert torch.equal(tg.gmlp_block_ref(*args), _block_by_whole_products(*args))


@pytest.mark.parametrize("mod,want", [(tg, {"sm90": 0, "wmma": 0}),
                                      (tgq, {"sm90_s8": 0, "mma_s8": 0})], ids=["bf16", "int8"])
def test_routes_read_without_loading_the_library(mod, want):
    assert mod.routes() == want
    assert not mod._LIB.loaded
