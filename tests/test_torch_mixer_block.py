"""The port's mixer-block twin against the Pallas kernel it replaces.

``mixer_block_ref`` (ops/kernels/mixer_block.py) is the plain PyTorch twin
of the CUDA kernel. Here it is held against
``jittor_mlp_tpu.ops.pallas.mixer_block.fused_mixer_block`` run in Pallas
interpret mode on the CPU, on the same seeded numpy inputs: float32 within
1e-5, bf16 within two bf16 ulps of the output scale (1.6e-2 of
max(1, max|want|)). The kernel itself runs only on the card (chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.mixer_block as jmb
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb

B, N, D, TD, CD = 4, 20, 32, 24, 64


def _inputs(seed=0):
    r = np.random.default_rng(seed)

    def rn(*s):
        return (r.standard_normal(s) * 0.1).astype(np.float32)

    x = r.standard_normal((B, N, D)).astype(np.float32)
    ln1w, ln2w = 1 + rn(D), 1 + rn(D)
    weights = (ln1w, rn(D), rn(TD, N), rn(TD), rn(N, TD), rn(N), ln2w, rn(D),
               rn(CD, D), rn(CD), rn(D, CD), rn(D))
    return x, weights


def _pallas_interpret(x, weights, dtype):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = jmb.fused_mixer_block(jnp.asarray(x, dtype),
                                    *(jnp.asarray(w, dtype) for w in weights),
                                    bt=2)
    finally:
        pl.pallas_call = orig
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_kernel(dtype):
    x, weights = _inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _pallas_interpret(x, weights, jdt)
    got = tmb.mixer_block_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt and got.shape == (B, N, D)
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def test_cpu_wrapper_runs_twin_without_launch():
    x, weights = _inputs(1)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    before = tmb.LAUNCHES
    got = tmb.fused_mixer_block(tx, *tw)
    assert tmb.LAUNCHES == before == 0
    assert torch.equal(got, tmb.mixer_block_ref(tx, *tw))


def test_wrapper_rejects_bad_inputs():
    x, weights = _inputs()
    tw = [_torch(w, torch.float32) for w in weights]
    with pytest.raises(ValueError):
        tmb.fused_mixer_block(_torch(x, torch.float32)[0], *tw)  # not 3-D
    with pytest.raises(ValueError):
        bad = list(tw)
        bad[2] = bad[2][:, :-1]  # wt1 with the wrong token count
        tmb.fused_mixer_block(_torch(x, torch.float32), *bad)
    with pytest.raises(TypeError):
        tmb.fused_mixer_block(torch.zeros((B, N, D), dtype=torch.int32), *tw)
    with pytest.raises(ValueError):  # weights on another device than x
        tmb.fused_mixer_block(_torch(x, torch.float32).to("meta"), *tw)
