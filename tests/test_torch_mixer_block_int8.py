"""The port's W8A8 mixer-block twin against the Pallas kernel it replaces.

``mixer_block_int8_ref`` (ops/kernels/mixer_block_int8.py) is the plain
PyTorch twin of the CUDA kernel. Here it is held against
``jittor_mlp_tpu.ops.pallas.mixer_block_int8.fused_mixer_block_int8`` run
in Pallas interpret mode on the CPU, on the same seeded numpy inputs, at a
small shape and at a shape whose 2048-wide channel hidden axis is chunked
(four chunks of 512, per-(row, chunk) activation scales): within 1.6e-2 of
max(1, max|want|). The twin runs its products through the s8 core's twin
on the kernel's operand layouts; written with whole products instead, the
block is the same bit for bit. The kernel itself runs only on the card
(chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.mixer_block_int8 as jq
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block_int8 as tq

SHAPES = {"small": (4, 20, 32, 24, 64), "chunked": (2, 20, 32, 24, 2048)}
# chunks of 514 columns, 544 codes (not a multiple of 128): chip_smoke.py's ragged chunk
RAGGED_CHUNK = (2, 13, 40, 24, 2056)


def _inputs(B, N, D, TD, CD, seed=0):
    r = np.random.default_rng(seed)

    def lin(out, fan_in):
        return ((r.standard_normal((out, fan_in)) / np.sqrt(fan_in)).astype(np.float32),
                (r.standard_normal(out) * 0.5).astype(np.float32))

    def ln():
        return ((1 + 0.1 * r.standard_normal(D)).astype(np.float32),
                (0.1 * r.standard_normal(D)).astype(np.float32))

    x = r.standard_normal((B, N, D)).astype(np.float32)
    return x, (*ln(), *lin(TD, N), *lin(N, TD), *ln(), *lin(CD, D), *lin(D, CD))


def _pallas_interpret(x, weights, dtype):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = jq.fused_mixer_block_int8(jnp.asarray(x, dtype),
                                        *(jnp.asarray(w, dtype) for w in weights), bt=2)
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
    want = _pallas_interpret(x, weights, jdt)
    got = tq.mixer_block_int8_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def test_int8_block_differs_from_bf16_block():
    x, weights = _inputs(*SHAPES["small"], seed=1)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    q = tq.mixer_block_int8_ref(tx, *tw).float()
    b = tmb.mixer_block_ref(tx, *tw).float()
    err = (q - b).abs().max().item()
    assert 0 < err <= 0.1 * max(1.0, b.abs().max().item()), err


def test_chunk_rule():
    assert [tq.chunk_size(cd) for cd in (64, 1536, 2048, 2056, 3072, 2050)] == \
        [64, 1536, 512, 514, 768, 2050]


def test_weight_operands_layout():
    """The kernel's int8 weight operands: rows padded with zero codes to a
    multiple of 32, Wc2 padded per chunk; dequantized, they are the twin's
    quantized weights."""
    _, w = _inputs(2, 20, 40, 24, 2056, seed=2)
    wt1, wt2, wc1, wc2 = (torch.from_numpy(w[i]) for i in (2, 4, 8, 10))
    ops = tq.weight_operands((wt1, wt2, wc1, wc2), tq.chunk_size(2056))
    shapes = [(24, 32), (24,), (20, 32), (20,), (2056, 64), (2056,), (40, 4 * 544), (40,)]
    assert [tuple(o.shape) for o in ops] == shapes
    assert all(o.is_contiguous() for o in ops)
    assert [o.dtype for o in ops[::2]] == [torch.int8] * 4
    for (q, s), wf in zip(zip(ops[::2], ops[1::2]), (wt1, wt2, wc1, wc2)):
        rows, cols = wf.shape
        ck = 514 if cols == 2056 else cols
        q = q.reshape(rows, -1, -(-ck // 32) * 32)
        assert (q[..., ck:] == 0).all()
        deq = q[..., :ck].reshape(rows, cols).float()
        want_q, want_s = tq.quant_weight(wf, 1)
        assert torch.equal(deq, want_q) and torch.equal(s, want_s.reshape(-1))


def test_cpu_wrapper_runs_twin_without_launch():
    x, weights = _inputs(*SHAPES["small"], seed=3)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    before = tq.LAUNCHES
    got = tq.fused_mixer_block_int8(tx, *tw)
    assert tq.LAUNCHES == before == 0
    assert torch.equal(got, tq.mixer_block_int8_ref(tx, *tw))


def test_wrapper_rejects_bad_inputs():
    x, weights = _inputs(*SHAPES["small"])
    tw = [_torch(w, torch.float32) for w in weights]
    with pytest.raises(ValueError):
        tq.fused_mixer_block_int8(_torch(x, torch.float32)[0], *tw)  # not 3-D
    with pytest.raises(ValueError):
        bad = list(tw)
        bad[10] = bad[10][:, :-1]  # wc2 with the wrong hidden width
        tq.fused_mixer_block_int8(_torch(x, torch.float32), *bad)
    with pytest.raises(TypeError):
        tq.fused_mixer_block_int8(torch.zeros(x.shape, dtype=torch.int32), *tw)
    with pytest.raises(ValueError):  # weights on another device than x
        tq.fused_mixer_block_int8(_torch(x, torch.float32).to("meta"), *tw)


def _int8_block_by_whole_products(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1,
                                  wc2, bc2):
    """The W8A8 block written with whole exact integer products on the
    unpadded codes, the second channel product summed chunk by chunk: the
    formulation the twin had before it was built from the s8 core's twin."""
    from jittor_mlp_tpu_torch.core.nnf import gelu_tanh
    from jittor_mlp_tpu_torch.quant import exact_int_matmul, quant_act, quant_weight
    dt = x.dtype
    B, N, D = x.shape
    CD = wc1.shape[0]
    qwt1, swt1 = quant_weight(wt1, 1)
    qwt2, swt2 = quant_weight(wt2, 1)
    qwc1, swc1 = quant_weight(wc1, 1)
    qwc2, swc2 = quant_weight(wc2, 1)
    qxn, sxn = quant_act(tmb.layer_norm_f32(x, ln1w, ln1b), 1)
    t = gelu_tanh(exact_int_matmul(qwt1, qxn) * swt1 * sxn + bt1.float()[:, None])
    qt, st = quant_act(t, 1)
    h = (x.float() + exact_int_matmul(qwt2, qt) * swt2 * st + bt2.float()[:, None]).to(dt)
    qhn, shn = quant_act(tmb.layer_norm_f32(h, ln2w, ln2b).reshape(B * N, D), 1)
    ck = tq.chunk_size(CD)
    acc = torch.zeros((B * N, D), dtype=torch.float32)
    for k0 in range(0, CD, ck):
        c = exact_int_matmul(qhn, qwc1[k0:k0 + ck].t()) * shn * swc1[k0:k0 + ck].t()
        qc, sc = quant_act(gelu_tanh(c + bc1.float()[k0:k0 + ck]), 1)
        acc = acc + exact_int_matmul(qc, qwc2[:, k0:k0 + ck].t()) * sc * swc2.t()
    return (h.float().reshape(B * N, D) + (acc + bc2.float())).reshape(B, N, D).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [*SHAPES.values(), RAGGED_CHUNK],
                         ids=[*SHAPES, "ragged_chunk"])
def test_ref_built_from_the_s8_core_twin_keeps_its_rounding(shape, dtype):
    """mixer_block_int8_ref runs its four products through gemm_s8_ref on
    the kernel's layouts (codes zero-padded to 32, the token products per
    image with the weight shared, the second channel product chunked with a
    row scale a chunk and ckp codes a chunk): bit for bit the block written
    with whole products, so every rounding point stayed where it was."""
    x, weights = _inputs(*shape, seed=6)
    tdt = getattr(torch, dtype)
    args = [_torch(a, tdt) for a in (x, *weights)]
    assert torch.equal(tq.mixer_block_int8_ref(*args), _int8_block_by_whole_products(*args))


def test_routes_read_without_loading_the_library():
    assert tq.routes() == {"sm90_s8": 0, "mma_s8": 0}
    assert not tq._LIB.loaded
