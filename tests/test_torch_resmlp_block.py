"""The port's ResMLP-block twins against the Pallas kernels they replace.

``resmlp_block_ref`` and ``resmlp_block_int8_ref`` are the plain PyTorch
twins of the two CUDA kernels. Here they are held against
``jittor_mlp_tpu.ops.pallas.resmlp_block.fused_resmlp_block`` and
``resmlp_block_int8.fused_resmlp_block_int8``, run in Pallas interpret mode
on the CPU, on the same seeded numpy inputs with γ and the affines at O(1):
the bf16 twin in float32 within 1e-5 and in bf16 within 1.6e-2 of
max(1, max|want|); the W8A8 twin within 1.6e-2 of max(1, max|want|), also
at a chunked FF width (2048: four chunks of 512). The kernels themselves
run only on the card (chip_smoke.py).
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
