"""The port's Mixer training kernels' twins against the Pallas kernels they
replace, and the two trainable blocks against the JAX custom VJPs.

``fwd_with_h_ref``, ``token_bwd_ref``, ``chan_data_bwd_ref`` and
``chan_wgt_bwd_ref`` (ops/kernels/mixer_block_bwd.py) are the plain
PyTorch twins of the four CUDA entries. Here each is held against its
Pallas kernel in ``jittor_mlp_tpu.ops.pallas.mixer_block_bwd``, run in
interpret mode on the CPU, on the same seeded numpy inputs, at a small
shape and at CD = 2048 (where the JAX channel kernels cut CD into four
chunks): every output within 1e-4 of max(1, max|want|) in float32 and
within two bf16 ulps (1.6e-2) of it in bf16. The port's
``fused_mixer_block_train`` (kernel route) and
``fused_mixer_block_trainable`` (recompute route) are held against
``jax.value_and_grad`` of their JAX counterparts for all 13 arguments, in
float32 within 1e-4. The kernels themselves run only on the card
(chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.mixer_block as jmb
import jittor_mlp_tpu.ops.pallas.mixer_block_bwd as jbwd
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block_bwd as tbwd

SHAPES = {"small": (4, 20, 32, 24, 64), "chunked": (2, 20, 32, 24, 2048)}
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def _inputs(B, N, D, TD, CD, seed=0):
    """x, the 12 block weights, and an upstream gradient shaped like x."""
    r = np.random.default_rng(seed)

    def v(n, scale, mean=0.0):
        return (mean + scale * r.standard_normal(n)).astype(np.float32)

    def lin(out, fan_in):
        return ((r.standard_normal((out, fan_in)) / np.sqrt(fan_in)).astype(np.float32),
                v(out, 0.5))

    x = r.standard_normal((B, N, D)).astype(np.float32)
    weights = (v(D, 0.1, 1.0), v(D, 0.1), *lin(TD, N), *lin(N, TD), v(D, 0.1, 1.0),
               v(D, 0.1), *lin(CD, D), *lin(D, CD))
    g = r.standard_normal((B, N, D)).astype(np.float32)
    return x, weights, g


def _interpret(fn, *args, **kw):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args, **kw)
    finally:
        pl.pallas_call = orig


def _call_args(kernel, x, weights, g):
    """The arguments of each kernel: (x, weights) for the forward;
    (x, dh, ln1w, ln1b, wt1, bt1, wt2) for the token backward (g stands in
    for dh); (h, g, ln2w, ln2b, bc1, wc1, wc2) for the channel backwards
    (x stands in for h)."""
    ln1w, ln1b, wt1, bt1, wt2, _, ln2w, ln2b, wc1, bc1, wc2, _ = weights
    if kernel == "fwd_with_h":
        return (x, *weights)
    if kernel == "token_bwd":
        return (x, g, ln1w, ln1b, wt1, bt1, wt2)
    return (x, g, ln2w, ln2b, bc1, wc1, wc2)


JAX_KERNELS = {"fwd_with_h": jbwd._fwd_with_h, "token_bwd": jbwd._token_bwd,
               "chan_data_bwd": jbwd._chan_data_bwd, "chan_wgt_bwd": jbwd._chan_wgt_bwd}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", list(JAX_KERNELS))
def test_twin_matches_pallas_kernel(kernel, dtype, shape):
    x, weights, g = _inputs(*SHAPES[shape])
    args = _call_args(kernel, x, weights, g)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _interpret(JAX_KERNELS[kernel], *(jnp.asarray(a, jdt) for a in args), bt=2)
    got = getattr(tbwd, f"{kernel}_ref")(*(torch.from_numpy(a).to(tdt) for a in args))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        assert tuple(a.shape) == b.shape, (i, a.shape, b.shape)
        # activations in the input dtype, weight/bias/LN gradients in f32
        assert a.dtype == (tdt if b.ndim == 3 else torch.float32), (i, a.dtype)
        err = np.abs(a.float().numpy() - b).max()
        assert err <= TOL[dtype] * max(1.0, np.abs(b).max()), (kernel, i, err)


@pytest.mark.parametrize("route", ["kernel", "recompute"])
def test_trainable_block_grads_match_jax(route):
    """value_and_grad of Σ out·w for all 13 arguments, f32 within 1e-4."""
    x, weights, _ = _inputs(*SHAPES["small"], seed=2)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    args = (x, *weights)

    if route == "kernel":
        def jblock(*a):
            return jbwd.fused_mixer_block_train(2, *a)
        tblock = tbwd.fused_mixer_block_train
    else:
        def jblock(*a):
            return jmb.fused_mixer_block_trainable(2, *a)
        tblock = tmb.fused_mixer_block_trainable

    def jloss(*a):
        return jnp.sum(jblock(*a) * w)

    with jconfig.parity_mode():
        jl, jg = _interpret(jax.value_and_grad(jloss, argnums=tuple(range(13))),
                            *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tl = (tblock(*targs) * torch.from_numpy(w)).sum()
    tg = torch.autograd.grad(tl, targs)
    assert abs(tl.item() - float(jl)) <= 1e-4 * max(1.0, abs(float(jl)))
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, i
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-4 * max(1.0, np.abs(b).max()), (i, err)


def test_plain_block_matches_jax_in_bf16():
    """mixer_block_plain against the JAX _plain_block in bf16: both round
    after every product and bias add (not where the kernel rounds)."""
    x, weights, _ = _inputs(*SHAPES["small"], seed=4)
    want = np.asarray(jmb._plain_block(*(jnp.asarray(a, jnp.bfloat16) for a in (x, *weights)))
                      .astype(jnp.float32))
    got = tmb.mixer_block_plain(*(torch.from_numpy(a).bfloat16() for a in (x, *weights)))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def test_cpu_wrappers_run_twins_without_launch():
    x, weights, g = _inputs(*SHAPES["small"], seed=1)
    before = dict(tbwd.LAUNCHES)
    for kernel in JAX_KERNELS:
        args = [torch.from_numpy(a).bfloat16() for a in _call_args(kernel, x, weights, g)]
        got = getattr(tbwd, kernel)(*args)
        want = getattr(tbwd, f"{kernel}_ref")(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kernel
    assert tbwd.LAUNCHES == before == dict.fromkeys(before, 0)


def test_wrappers_reject_bad_inputs():
    x, weights, g = _inputs(*SHAPES["small"])
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tw = [torch.from_numpy(a) for a in weights]
    ln1w, ln1b, wt1, bt1, wt2, _, ln2w, ln2b, wc1, bc1, wc2, _ = tw
    with pytest.raises(ValueError):  # dh of another shape than x
        tbwd.token_bwd(tx, tg[:, :-1], ln1w, ln1b, wt1, bt1, wt2)
    with pytest.raises(ValueError):  # wt2 transposed
        tbwd.token_bwd(tx, tg, ln1w, ln1b, wt1, bt1, wt2.t())
    with pytest.raises(ValueError):  # wc1 with the wrong width
        tbwd.chan_wgt_bwd(tx, tg, ln2w, ln2b, bc1, wc1[:, :-1], wc2)
    with pytest.raises(TypeError):
        tbwd.chan_data_bwd(tx.int(), tg, ln2w, ln2b, bc1, wc1, wc2)
    with pytest.raises(ValueError):  # no kernel for the meta device
        tbwd.fwd_with_h(tx.to("meta"), *(a.to("meta") for a in tw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chan_wgt_twin_in_slabs_matches_pallas_kernel(dtype):
    """chan_wgt_bwd_ref sums dWc1 = dcpᵀ·hn and dWc2 = gᵀ·c in row slabs of
    whole images (the MN-major slab twin, gemm_bf16_ref, its partials added
    in order by sum_slabs_ref), as the kernel does on the card: at B = 5
    with 2 images a slab (slabs of 2, 2 and a short last 1) it matches the
    Pallas _chan_wgt_bwd within the tolerances above."""
    x, weights, g = _inputs(5, 20, 32, 24, 64, seed=7)
    args = _call_args("chan_wgt_bwd", x, weights, g)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _interpret(jbwd._chan_wgt_bwd, *(jnp.asarray(a, jdt) for a in args), bt=1)
    targs = [torch.from_numpy(a).to(tdt) for a in args]
    got = tbwd.chan_wgt_bwd_ref(*targs, images_per_slab=2)
    whole = tbwd.chan_wgt_bwd_ref(*targs)
    for i, (a, b, c) in enumerate(zip(got, want, whole)):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, i
        err = np.abs(a.numpy() - b).max()
        assert err <= TOL[dtype] * max(1.0, np.abs(b).max()), (i, err)
        # the slab cut changes only the f32 order of the sum
        assert (a - c).abs().max().item() <= 1e-5 * max(1.0, c.abs().max().item()), i
    assert torch.equal(got[2], whole[2])  # dbc1 is not cut in slabs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_twin_in_groups_matches_pallas_kernel(dtype):
    """token_bwd_ref sums dWt2 = Σ dh_b·t_bᵀ and dWt1 = Σ dtp_b·xn_bᵀ in
    groups of whole images (the core's Group mode twin, its partials added
    in order), as the kernel does on the card: at B = 5 in groups of 2
    (2, 2 and a short last 1) it matches the Pallas _token_bwd within the
    tolerances above, and differs from one group only in f32 order."""
    x, weights, g = _inputs(5, 20, 32, 24, 64, seed=8)
    args = _call_args("token_bwd", x, weights, g)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _interpret(jbwd._token_bwd, *(jnp.asarray(a, jdt) for a in args), bt=1)
    targs = [torch.from_numpy(a).to(tdt) for a in args]
    got = tbwd.token_bwd_ref(*targs, images_per_group=2)
    whole = tbwd.token_bwd_ref(*targs)
    for i, (a, b, c) in enumerate(zip(got, want, whole)):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        err = np.abs(a.float().numpy() - b).max()
        assert err <= TOL[dtype] * max(1.0, np.abs(b).max()), (i, err)
        assert (a.float() - c.float()).abs().max().item() <= 1e-5 * max(
            1.0, c.float().abs().max().item()), i
    for i in (0, 3, 4, 5):  # dx, dbt1 and the LN1 gradients are not cut in groups
        assert torch.equal(got[i], whole[i]), i


@pytest.mark.parametrize("D", [32, 36, 5])
def test_dbt1_partials_sum_runs_of_eight_columns_in_order(D):
    """The token kernel's dbt1 partials: each run of eight columns (the
    last may be shorter) summed in column order from its first, bit for
    bit a numpy float32 loop."""
    d = np.random.default_rng(D).standard_normal((3, 4, D)).astype(np.float32)
    got = tbwd._run_sums(torch.from_numpy(d))
    want = np.zeros((3, 4, -(-D // 8)), np.float32)
    for c in range(0, D, 8):
        acc = d[..., c]
        for e in range(c + 1, min(c + 8, D)):
            acc = acc + d[..., e]
        want[..., c // 8] = acc
    assert np.array_equal(got.numpy(), want)


def test_routes_and_mode_launches_read_without_loading_the_library():
    if tbwd._LIB.loaded:
        pytest.fail("the CPU tests must not load the kernel library")
    assert tbwd.routes() == {"sm90": 0, "wmma": 0}
    assert tbwd.mode_launches() == {"plain": 0, "dual": 0, "group": 0, "handoff": 0}
    assert not tbwd._LIB.loaded
