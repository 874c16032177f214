"""The port's ResMLP-block twins against the Pallas kernels they replace.

``resmlp_block_ref`` and ``resmlp_block_int8_ref`` are the plain PyTorch
twins of the two CUDA kernels. Here they are held against
``jittor_mlp_tpu.ops.pallas.resmlp_block.fused_resmlp_block`` and
``resmlp_block_int8.fused_resmlp_block_int8``, run in Pallas interpret mode
on the CPU, on the same seeded numpy inputs with γ and the affines at O(1):
the bf16 twin in float32 within 1e-5 and in bf16 within 1.6e-2 of
max(1, max|want|); the W8A8 twin within 1.6e-2 of max(1, max|want|), also
at a chunked FF width (2048: four chunks of 512). Both twins run their
products through the GEMM core's twins on the kernels' layouts; written
with whole products instead, each block is the same bit for bit. The
kernels themselves run only on the card (chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.resmlp_block as jr
import jittor_mlp_tpu.ops.pallas.resmlp_block_int8 as jrq
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block as tr
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block_int8 as trq

SHAPES = {"small": (4, 20, 32, 96), "chunked": (2, 20, 32, 2048)}


def _inputs(B, N, D, F, seed=0):
    r = np.random.default_rng(seed)

    def v(scale, mean=0.0, n=D):
        return (mean + scale * r.standard_normal(n)).astype(np.float32)

    def lin(out, fan_in):
        return ((r.standard_normal((out, fan_in)) / np.sqrt(fan_in)).astype(np.float32),
                v(0.5, n=out))

    x = r.standard_normal((B, N, D)).astype(np.float32)
    a1, b1, g1 = v(0.1, 1.0), v(0.5), v(0.1, 1.0)
    wt, bt = lin(N, N)
    a2, b2, g2 = v(0.1, 1.0), v(0.5), v(0.1, 1.0)
    return x, (a1, b1, g1, wt, bt, a2, b2, g2, *lin(F, D), *lin(D, F))


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
def test_ref_matches_pallas_kernel(dtype):
    x, weights = _inputs(*SHAPES["small"])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _pallas_interpret(jr.fused_resmlp_block, x, weights, jdt)
    got = tr.resmlp_block_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
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
    want = _pallas_interpret(jrq.fused_resmlp_block_int8, x, weights, jdt)
    got = trq.resmlp_block_int8_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def test_int8_block_differs_from_bf16_block():
    x, weights = _inputs(*SHAPES["small"], seed=2)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    q = trq.resmlp_block_int8_ref(tx, *tw).float()
    b = tr.resmlp_block_ref(tx, *tw).float()
    err = (q - b).abs().max().item()
    assert 0 < err <= 0.1 * max(1.0, b.abs().max().item()), err


@pytest.mark.parametrize("mod,fn,ref", [
    (tr, "fused_resmlp_block", "resmlp_block_ref"),
    (trq, "fused_resmlp_block_int8", "resmlp_block_int8_ref"),
], ids=["bf16", "int8"])
def test_cpu_wrapper_runs_twin_without_launch(mod, fn, ref):
    x, weights = _inputs(*SHAPES["small"], seed=3)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    before = mod.LAUNCHES
    got = getattr(mod, fn)(tx, *tw)
    assert mod.LAUNCHES == before == 0
    assert torch.equal(got, getattr(mod, ref)(tx, *tw))


@pytest.mark.parametrize("fn", [tr.fused_resmlp_block, trq.fused_resmlp_block_int8],
                         ids=["bf16", "int8"])
def test_wrapper_rejects_bad_inputs(fn):
    x, weights = _inputs(*SHAPES["small"])
    tw = [_torch(w, torch.float32) for w in weights]
    with pytest.raises(ValueError):
        fn(_torch(x, torch.float32)[0], *tw)  # not 3-D
    with pytest.raises(ValueError):
        bad = list(tw)
        bad[3] = bad[3][:, :-1]  # token-mix weight with the wrong token count
        fn(_torch(x, torch.float32), *bad)
    with pytest.raises(TypeError):
        fn(torch.zeros(x.shape, dtype=torch.int32), *tw)
    with pytest.raises(ValueError):  # weights on another device than x
        fn(_torch(x, torch.float32).to("meta"), *tw)


def _block_by_whole_products(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """The bf16 block written with whole f32 products on the (B, N, ·)
    tensors, the token product as one matmul broadcast over the images: the
    formulation the twin had before it was built from the bf16 core's twin."""
    from jittor_mlp_tpu_torch.core.nnf import gelu_erf, gelu_tanh
    dt = x.dtype
    act = gelu_erf if dt == torch.float32 else gelu_tanh
    h = (x.float() * a1.float() + b1.float()).to(dt)
    t = torch.matmul(wt.float(), h.float()) + bt.float()[:, None]
    h2 = h.float() + g1.float() * t
    h2 = h2 * a2.float() + b2.float()
    c = act(torch.matmul(h2.to(dt).float(), w1.float().t()) + c1.float()).to(dt)
    f = torch.matmul(c.float(), w2.float().t()) + c2.float()
    return (h2 + g2.float() * f).to(dt)


# beyond SHAPES: a ragged chunk (F = 2056: four chunks of 514 codes padded to
# 544) with ragged tokens and width (N = 13 in rows of 16 or 32, D = 36)
TWIN_SHAPES = {**SHAPES, "ragged_chunk": (2, 13, 36, 2056)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(TWIN_SHAPES), ids=list(TWIN_SHAPES))
def test_ref_built_from_the_bf16_core_twin_keeps_its_rounding(shape, dtype):
    """resmlp_block_ref runs its three products through gemm_bf16_ref on the
    kernel's layouts (Wt copied into rows of Np = round_up(N, 8) and read as
    its first N columns, shared; h an N-major B operand an entry an image):
    bit for bit the block written with whole products."""
    x, weights = _inputs(*TWIN_SHAPES[shape], seed=7)
    tdt = getattr(torch, dtype)
    args = [_torch(a, tdt) for a in (x, *weights)]
    assert torch.equal(tr.resmlp_block_ref(*args), _block_by_whole_products(*args))


def _int8_block_by_whole_products(x, a1, b1, g1, wt, bt, a2, b2, g2, w1, c1, w2, c2):
    """The W8A8 block written with whole exact integer products on the
    unpadded codes, per image for the token product, the FF summed chunk by
    chunk: the formulation the twin had before it was built from the s8
    core's twin."""
    from jittor_mlp_tpu_torch.core.nnf import gelu_tanh
    from jittor_mlp_tpu_torch.quant import exact_int_matmul, quant_act, quant_weight
    dt = x.dtype
    B, N, D = x.shape
    F = w1.shape[0]
    qwt, swt = quant_weight(wt, 1)
    qw1, sw1 = quant_weight(w1, 1)
    qw2, sw2 = quant_weight(w2, 1)
    h = x.float() * a1.float() + b1.float()
    qh, sh = quant_act(h, 1)
    t = exact_int_matmul(qwt, qh) * swt * sh + bt.float()[:, None]
    h = h + g1.float() * t
    hb = (h * a2.float() + b2.float()).reshape(B * N, D)
    qhb, shb = quant_act(hb, 1)
    ck = trq.chunk_size(F)
    acc = torch.zeros((B * N, D), dtype=torch.float32)
    for k0 in range(0, F, ck):
        c = exact_int_matmul(qhb, qw1[k0:k0 + ck].t()) * shb * sw1[k0:k0 + ck].t()
        qc, sc = quant_act(gelu_tanh(c + c1.float()[k0:k0 + ck]), 1)
        acc = acc + exact_int_matmul(qc, qw2[:, k0:k0 + ck].t()) * sc * sw2.t()
    return (hb + g2.float() * (acc + c2.float())).reshape(B, N, D).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(TWIN_SHAPES), ids=list(TWIN_SHAPES))
def test_int8_ref_built_from_the_s8_core_twin_keeps_its_rounding(shape, dtype):
    """resmlp_block_int8_ref runs its three products through gemm_s8_ref on
    the kernel's layouts (codes zero-padded to 32, the token product per
    image with qWt shared, FF2 chunked with a row scale a chunk and ckp codes
    a chunk where F >= 2048, unchunked otherwise): bit for bit the block
    written with whole products, so every rounding point stayed where it
    was."""
    x, weights = _inputs(*TWIN_SHAPES[shape], seed=6)
    tdt = getattr(torch, dtype)
    args = [_torch(a, tdt) for a in (x, *weights)]
    assert torch.equal(trq.resmlp_block_int8_ref(*args), _int8_block_by_whole_products(*args))


@pytest.mark.parametrize("mod,want", [(tr, {"sm90": 0, "wmma": 0}),
                                      (trq, {"sm90_s8": 0, "mma_s8": 0})], ids=["bf16", "int8"])
def test_routes_read_without_loading_the_library(mod, want):
    assert mod.routes() == want
    assert not mod._LIB.loaded
