"""The port's kernel lab against the JAX tool's Pallas bodies it replaces.

``tools/kernel_lab.py`` (JAX) is loaded by path with its shape constants set
to a small block, and its ``_call`` / ``_call_tokmajor`` run in Pallas
interpret mode on the CPU. The port's wrappers (``ops/kernels/kernel_lab.py``)
take CPU tensors to their plain twins. Same seeded numpy inputs on both
sides; float32 within 1e-5, bf16 within two bf16 ulps of the output scale
(1.6e-2 of max(1, max|want|)), as for kernel 1. The CUDA kernels run only on
the card (chip_smoke.py).
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu.ops.pallas.mixer_block import _plain_block
from jittor_mlp_tpu_torch.ops.kernels import kernel_lab as tkl
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as mbk
from jittor_mlp_tpu_torch.tools import kernel_lab as lab

B, N, D, TD, CD = 8, 20, 32, 24, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATIONS = {name: (kw["gelu"], kw["ln"])  # the lab's five: name → (gelu, ln)
             for name, (fn, kw) in lab.VARIANTS.items() if fn == "ablate_block"}


@pytest.fixture(scope="module")
def jlab():
    """The JAX tool as a module of its own, its shape constants at the test size."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_lab", os.path.join(REPO, "tools", "kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N, mod.D, mod.TD, mod.CD = N, D, TD, CD
    return mod


def _inputs(seed=0):
    r = np.random.default_rng(seed)

    def rn(*s):
        return (r.standard_normal(s) * 0.1).astype(np.float32)

    x = r.standard_normal((B, N, D)).astype(np.float32)
    weights = (1 + rn(D), rn(D), rn(TD, N), rn(TD), rn(N, TD), rn(N), 1 + rn(D), rn(D),
               rn(CD, D), rn(CD), rn(D, CD), rn(D))
    return x, weights


def _interpret(fn, x, weights, dtype):
    """fn(x, weights) of the JAX tool in Pallas interpret mode, as float32 numpy."""
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        with jconfig.parity_mode():
            out = fn(jnp.asarray(x, dtype), tuple(jnp.asarray(w, dtype) for w in weights))
    finally:
        pl.pallas_call = orig
    return np.asarray(out.astype(jnp.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _port(fn, x, weights, dtype):
    tdt = getattr(torch, dtype)
    got = fn(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt
    return got.float().numpy()


def _assert_band(got, want, dtype):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("bt", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_matches_pallas(jlab, dtype, bt):
    x, weights = _inputs()
    want = _interpret(lambda x, w: jlab._call(jlab._kernel_wide, x, w, bt, True), x, weights,
                      getattr(jnp, dtype))
    got = _port(functools.partial(tkl.wide_block, bt=bt), x, weights, dtype)
    _assert_band(got, want, dtype)


@pytest.mark.parametrize("bt", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tokmajor_matches_pallas(jlab, dtype, bt):
    x, weights = _inputs(1)
    xt = np.ascontiguousarray(x.reshape(B // bt, bt, N, D).transpose(0, 2, 1, 3))
    want = _interpret(lambda x, w: jlab._call_tokmajor(x, w, bt), xt, weights,
                      getattr(jnp, dtype))
    got = _port(functools.partial(tkl.tokmajor_block, bt=bt), xt, weights, dtype)
    assert got.shape == (B // bt, N, bt, D)
    _assert_band(got, want, dtype)


@pytest.mark.parametrize("bt", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noscratch_matches_pallas(jlab, dtype, bt):
    x, weights = _inputs(2)
    want = _interpret(lambda x, w: jlab._call(jlab._kernel_noscratch, x, w, bt, False), x,
                      weights, getattr(jnp, dtype))
    got = _port(functools.partial(tkl.noscratch_block, bt=bt), x, weights, dtype)
    _assert_band(got, want, dtype)


@pytest.mark.parametrize("name", list(ABLATIONS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ablate_matches_pallas(jlab, dtype, name):
    gelu, ln = ABLATIONS[name]
    x, weights = _inputs(3)
    want = _interpret(
        lambda x, w: jlab._call(jlab._make_kernel_ablate(gelu, ln), x, w, 2, True), x, weights,
        getattr(jnp, dtype))
    got = _port(functools.partial(tkl.ablate_block, bt=2, gelu=gelu, ln=ln), x, weights, dtype)
    _assert_band(got, want, dtype)


@pytest.mark.parametrize("bt", [2, 4, 8])
def test_relayouts_equal_jax(jlab, bt):
    x, _ = _inputs(4)
    xt = tkl.to_tokmajor(torch.from_numpy(x), bt)
    assert xt.is_contiguous()
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jlab._to_tokmajor(jnp.asarray(x), bt)))
    back = tkl.from_tokmajor(xt)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jlab._from_tokmajor(jnp.asarray(
        xt.numpy()))))
    np.testing.assert_array_equal(back.numpy(), x)


def test_plain_matches_jax_plain_block():
    x, weights = _inputs(5)
    with jconfig.parity_mode():
        want = np.asarray(_plain_block(jnp.asarray(x), *(jnp.asarray(w) for w in weights)))
    got = lab.plain(tuple(torch.from_numpy(w) for w in weights), torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5


WRAPPERS = {
    "tokmajor_block": lambda x, w: tkl.tokmajor_block(tkl.to_tokmajor(x, 2), *w, bt=2),
    "wide_block": lambda x, w: tkl.wide_block(x, *w, bt=2),
    "noscratch_block": lambda x, w: tkl.noscratch_block(x, *w, bt=4),
    "ablate_block": lambda x, w: tkl.ablate_block(x, *w, bt=2, gelu="fast3", ln=False),
}
TWINS = {
    "tokmajor_block": lambda x, w: tkl.tokmajor_block_ref(tkl.to_tokmajor(x, 2), *w, bt=2),
    "wide_block": lambda x, w: tkl.wide_block_ref(x, *w, bt=2),
    "noscratch_block": lambda x, w: tkl.noscratch_block_ref(x, *w, bt=4),
    "ablate_block": lambda x, w: tkl.ablate_block_ref(x, *w, bt=2, gelu="fast3", ln=False),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cpu_wrapper_runs_twin_without_launch(name):
    x, weights = _inputs(6)
    tx, tw = _torch(x, torch.bfloat16), [_torch(w, torch.bfloat16) for w in weights]
    before = dict(tkl.LAUNCHES)
    got = WRAPPERS[name](tx, tw)
    assert tkl.LAUNCHES == before and tkl.LAUNCHES[name] == 0
    assert torch.equal(got, TWINS[name](tx, tw))


@pytest.mark.parametrize("case", ["ragged_batch", "dtype", "weight_shape", "weight_device",
                                  "tokmajor_bt", "gelu"])
def test_wrappers_reject_bad_inputs(case):
    x, weights = _inputs()
    tx, tw = _torch(x, torch.float32), [_torch(w, torch.float32) for w in weights]
    if case == "ragged_batch":  # B = 8 is no multiple of 3: the JAX grid drops the tail
        for fn in (tkl.wide_block, tkl.noscratch_block):
            with pytest.raises(ValueError, match="multiple"):
                fn(tx, *tw, bt=3)
        with pytest.raises(ValueError, match="multiple"):
            tkl.ablate_block(tx, *tw, bt=3, gelu="relu", ln=True)
    elif case == "dtype":
        with pytest.raises(TypeError):
            tkl.wide_block(tx.to(torch.int32), *tw, bt=2)
        with pytest.raises(TypeError):
            tkl.tokmajor_block(tkl.to_tokmajor(tx, 2).to(torch.int32), *tw, bt=2)
    elif case == "weight_shape":
        bad = list(tw)
        bad[4] = bad[4][:-1]  # wt2 with one token too few
        with pytest.raises(ValueError):
            tkl.noscratch_block(tx, *bad, bt=2)
        with pytest.raises(ValueError):
            tkl.tokmajor_block(tkl.to_tokmajor(tx, 2), *bad, bt=2)
    elif case == "weight_device":
        with pytest.raises(ValueError):
            tkl.ablate_block(tx.to("meta"), *tw, bt=2, gelu="exact", ln=True)
        with pytest.raises(ValueError):
            tkl.wide_block(tx.to("meta"), *tw, bt=2)
    elif case == "tokmajor_bt":
        with pytest.raises(ValueError):
            tkl.tokmajor_block(tkl.to_tokmajor(tx, 4), *tw, bt=2)
        with pytest.raises(ValueError):
            tkl.tokmajor_block(tx, *tw, bt=2)  # (B, N, D), not token-major
    else:
        with pytest.raises(ValueError):
            tkl.ablate_block(tx, *tw, bt=2, gelu="erf", ln=True)


def test_check_and_bench_stack_on_cpu():
    weights = lab.make_weights(0, "cpu", N, D, TD, CD)
    assert all(w.dtype == torch.bfloat16 for w in weights)
    assert torch.equal(weights[8], lab.make_weights(0, "cpu", N, D, TD, CD)[8])
    errs = lab.check(weights, lab.make_input(1, 8, "cpu", N, D))
    assert set(errs) == {"wide", "noscratch", "tokmajor"}
    stacked = [tuple(w.clone() for w in weights) for _ in range(lab.DEPTH)]
    x = lab.make_input(2, 4, "cpu", N, D)
    table = lab.variants()
    assert len(table) == 15
    for name in ("wide2", "tokmajor4", "gelu_fast3", "plain"):
        block, pre, post = table[name]
        out, stats = lab.bench_stack(name, block, stacked, x, iters=2, pre=pre, post=post)
        assert stats["passes"] == 3 and stats["img_s"] > 0
        h = pre(x) if pre else x
        for w in stacked:
            h = block(w, h)
        want = post(h) if post else h
        assert out.shape == x.shape and torch.equal(out, want)
    assert tkl.LAUNCHES == dict.fromkeys(tkl.LAUNCHES, 0)


def test_bf16_ulp():
    v = torch.tensor([1.0, -1.5, 3.0, 4.0, 5.06, 0.3])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6, 2.0 ** -5, 2.0 ** -5, 2.0 ** -9])
    assert torch.equal(lab.bf16_ulp(v), want)
    b = v.bfloat16().float()
    assert torch.equal((b + lab.bf16_ulp(b)).bfloat16().float(), b + lab.bf16_ulp(b))


@pytest.mark.parametrize("case", ["wide_off_2e-2", "tokmajor_one_ulp", "tokmajor_two_ulps"])
def test_check_bounds(monkeypatch, case):
    """wide and noscratch within 1e-2 of kernel 1, tokmajor within
    max(1e-2, one bf16 ulp) of each of kernel 1's outputs."""
    weights = lab.make_weights(0, "cpu", N, D, TD, CD)
    x = lab.make_input(1, 8, "cpu", N, D)
    if case == "wide_off_2e-2":
        monkeypatch.setattr(tkl, "wide_block", lambda x, *w, bt: (
            tkl.wide_block_ref(x, *w, bt=bt).float() + 2e-2).bfloat16())
    else:
        ulps = 1 if case == "tokmajor_one_ulp" else 2

        def off(x, *w, bt):
            want = mbk.mixer_block_ref(tkl.from_tokmajor(x), *w).float()
            return tkl.to_tokmajor((want + ulps * lab.bf16_ulp(want)).bfloat16(), bt)

        monkeypatch.setattr(tkl, "tokmajor_block", off)
    if case == "tokmajor_one_ulp":
        assert lab.check(weights, x)["tokmajor"] > 1e-2  # outside the JAX tool's bound
    else:
        with pytest.raises(RuntimeError, match=case.split("_")[0]):
            lab.check(weights, x)


def test_bench_times_same_as_variants_once():
    weights = lab.make_weights(5, "cpu", N, D, TD, CD)
    stats = lab.bench(["noscratch2", "noscratch4", "prod4"], weights, 4, 1)
    assert stats["noscratch4"] == dict(stats["noscratch2"], same_as="noscratch2")
    assert "same_as" not in stats["prod4"]  # prod2 did not run: prod4 is timed itself
    assert set(lab.SAME_AS.items()) == {("prod4", "prod2"), ("noscratch4", "noscratch2")}
    for alias, of in lab.SAME_AS.items():
        assert lab.VARIANTS[alias][0] == lab.VARIANTS[of][0]


def test_stack_equals_sequential_twins():
    weights = lab.make_weights(3, "cpu", N, D, TD, CD)
    stacked = [tuple(w.clone() for w in weights) for _ in range(lab.DEPTH)]
    x = lab.make_input(4, 4, "cpu", N, D)
    block, pre, post = lab.variants()["tokmajor2"]
    out, _ = lab.bench_stack("tokmajor2", block, stacked, x, iters=2, pre=pre, post=post)
    h = tkl.to_tokmajor(x, 2)
    for w in stacked:
        h = tkl.tokmajor_block_ref(h, *w, bt=2)
    assert torch.equal(out, tkl.from_tokmajor(h))
    out, _ = lab.bench_stack("noscratch4", lab.variants()["noscratch4"][0], stacked, x, iters=2)
    h = x
    for w in stacked:
        h = tkl.noscratch_block_ref(h, *w, bt=4)
    assert torch.equal(out, h)
    assert not torch.equal(out, x)
