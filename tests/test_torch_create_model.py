"""The port's create_model walkthrough (jittor_mlp_tpu_torch/examples/
create_model.py) against the JAX package's models at batch 1, on the CPU.

Each row's output shape equals the JAX model's, and its parameter count the
sizes of the same tensors in the JAX model's exported state dict (for the
three light factories also the JAX ``param_count()``; elsewhere the JAX
params hold BatchNorm statistics and a few other arrays beside the
weights). Its FLOPs (``Model.flops``: the products and convolutions,
2·M·N·K each) equal the products and convolutions of the JAX forward's
jaxpr, counted the same way (``jax_product_flops``), except in the
families whose JAX forward computes more products (``MORE_PRODUCTS``),
where they are fewer. The JAX ``Model.flops`` reads XLA's cost analysis,
which also counts elementwise work, and is never below the product count
but where a loop stays rolled (``XLA_COUNTS_LOOP_ONCE``).
Three light factories run by default, the full 33 under ``-m slow``.
"""

import importlib.util
import os

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu.core import nnf as jnnf
from jittor_mlp_tpu_torch.examples import create_model as cm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT = ["ResMLPForImageClassification", "RaftMLP", "MLPMixerForImageClassification"]
# the families whose JAX forward forms more products than the port's: GFNet's
# filter as DFT products (the port: cuFFT, which the counter counts 0),
# CycleFC as one product a shift and ActiveMLP's sampler as hat-function
# products (the port: copies or gathers, then one product), and the BiLSTM's
# products in Sequencer2D
MORE_PRODUCTS = {"GFNet", "GFNetPyramid", "CycleMLP_B1", "CycleMLP_B2", "CycleMLP_B3",
                 "CycleMLP_B4", "CycleMLP_B5", "ActiveSmall", "ActiveBase", "ActiveLarge",
                 "Sequencer2D"}
# XLA's cost analysis counts the body of a scan left rolled once (the JAX
# Model.flops docstring): Sequencer2D's LSTM time loop
XLA_COUNTS_LOOP_ONCE = {"Sequencer2D"}


def jax_product_flops(jaxpr):
    """2·M·N·K of every dot_general and 2·out·(in/groups·kernel) of every
    convolution in ``jaxpr``, its sub-jaxprs included (a scan's body times
    its length)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * int(np.prod(eqn.outvars[0].aval.shape)) * int(
                np.prod([lhs[d] for d in contract]))
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            out_axis = eqn.params["dimension_numbers"].rhs_spec[0]
            total += 2 * int(np.prod(eqn.outvars[0].aval.shape)) * (
                int(np.prod(rhs)) // rhs[out_axis])
        times = eqn.params.get("length", 1) if name == "scan" else 1
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    total += times * jax_product_flops(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    total += times * jax_product_flops(sub)
    return total


def jax_row(name, size):
    """(the JAX model, its product FLOPs, XLA's FLOPs, output shape) of
    ``name`` at batch 1."""
    model = getattr(jm, name)(**cm.KWARGS.get(name, {}))
    x = jnp.zeros((1, 3, size, size), jnp.float32)
    jnnf._FULL_UNROLL = True  # the Model.flops unrolling: every block in the jaxpr
    try:
        jaxpr = jax.make_jaxpr(lambda p, v: model.apply(p, v))(model.params, x)
    finally:
        jnnf._FULL_UNROLL = False
    out = model(np.zeros((1, 3, size, size), np.float32))
    return model, jax_product_flops(jaxpr.jaxpr), model.flops(x.shape), out.shape


def check_row(name):
    size = cm.INPUT_SIZE.get(name, 224)
    params, flops, shape, ms = cm.row(name, batch=1, device="cpu")
    jax_model, j_flops, xla_flops, j_shape = jax_row(name, size)
    names = [k for k, _ in getattr(jt, name)(**cm.KWARGS.get(name, {}),
                                             device="cpu").named_parameters()]
    sd = jax_model.export_torch_state_dict(tensors=False)
    assert params == sum(np.size(sd[k]) for k in names)
    if name in LIGHT:
        assert params == jax_model.param_count()
    if name in MORE_PRODUCTS:
        assert flops < j_flops
    else:
        assert f"{flops / 1e9:.2f}" == f"{j_flops / 1e9:.2f}"
    if name not in XLA_COUNTS_LOOP_ONCE:
        assert xla_flops >= j_flops * (1 - 1e-6)
    assert shape == tuple(j_shape) and ms is None


@pytest.mark.parametrize("name", LIGHT)
def test_row_matches_jax(name):
    check_row(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in cm.FACTORIES if n not in LIGHT])
def test_row_matches_jax_zoo(name):
    check_row(name)


def test_tables_are_the_jax_scripts():
    spec = importlib.util.spec_from_file_location(
        "jax_create_model", os.path.join(ROOT, "examples", "create_model.py"))
    jax_cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cm)
    assert cm.FACTORIES == jax_cm.FACTORIES and len(cm.FACTORIES) == 33
    assert cm.KWARGS == jax_cm.KWARGS and cm.INPUT_SIZE == jax_cm.INPUT_SIZE


def test_main_prints_rows_and_counts_failures(capsys):
    assert cm.main(["--model", "RaftMLP", "--device", "cpu", "--batch", "1", "--time"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("RaftMLP"))
    params, _, _, _ = cm.row("RaftMLP", batch=1, device="cpu")
    assert f"{params:,}" in line and "(1, 1000)" in line and "ms/fwd" in out
    assert float(line.split()[-1]) > 0
    assert cm.main(["--model", "NoSuchFactory", "--device", "cpu"]) == 1
    assert "NoSuchFactory" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the card by default, no CPU fallback
        with pytest.raises(RuntimeError):
            cm.row("RaftMLP", batch=1)
