"""The Mixer block forward's GEMM routes and its wrappers' launch arguments,
without a card.

``csrc/mixer_forward.cuh`` runs the block's four products (the two token
products an entry an image, the two channel products over all rows) on the
wgmma core where TMA can load both operands, else on the WMMA core. TMA
needs every row stride to be a multiple of 16 bytes. Wt1 is copied into
rows of round_up(N, 8) for that, so the first token product needs D % 8 ==
0 (xn), the second D % 8 == 0 and TD % 8 == 0 (t, Wt2), the channel
products D % 8 == 0 (hn, Wc1) and CD % 8 == 0 (c, Wc2). chip_smoke.py's
``ROUTED`` table states the rule and its phases hold the kernels' counts to
it on the card; here the table is held to the operands' strides, phase 2's
shapes to the route cases, and each wrapper's launch arguments to its C
entry's parameters, through a launch that only records them.
"""

import os
import re

import pytest
import torch

import chip_smoke as cs
from jittor_mlp_tpu_torch.ops.kernels import _build
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block_bwd as tbwd
from jittor_mlp_tpu_torch.tools import mutation_check

MIXER_B16 = (8, 196, 768, 384, 3072)


def _rule(shape):
    """{"sm90": n, "wmma": n} from the four products' operands: the elements
    between rows of (A, B) each, bf16, 16-byte multiples for TMA."""
    _, N, D, TD, CD = shape
    Np = -(-N // 8) * 8
    products = [(Np, D), (TD, D), (D, D), (CD, CD)]
    sm90 = sum(all(2 * ld % 16 == 0 for ld in pair) for pair in products)
    return {"sm90": sm90, "wmma": len(products) - sm90}


@pytest.mark.parametrize("shape, want", [
    (MIXER_B16, {"sm90": 4, "wmma": 0}),
    (cs.MIXER_ROUTE_SHAPES[0], {"sm90": 4, "wmma": 0}),  # N = 33: Wt1 in rows of 40
    (cs.MIXER_ROUTE_SHAPES[1], {"sm90": 3, "wmma": 1}),  # TD = 50: Wt2's rows on WMMA
    (cs.MIXER_ROUTE_SHAPES[2], {"sm90": 0, "wmma": 4}),  # D = 36, CD = 100
])
def test_route_table_follows_the_operands_strides(shape, want):
    assert cs.ROUTED["fused_mixer_block"](shape) == want
    assert cs.ROUTED["fwd_with_h"](shape) == want
    assert _rule(shape) == want


def test_products_a_block_and_a_kernel_route_step():
    assert cs.BLOCK_PRODUCTS["mixer_block"] == ("sm90", 4)
    assert cs.BWD_PRODUCTS["fwd_with_h"] == 4
    assert sum(cs.BWD_PRODUCTS.values()) == 16


def test_phase_two_covers_the_three_route_cases():
    mods = {m: None for m in cs.KERNEL_MODULES}
    table = cs.kernel_table(mods)
    for name in ("fused_mixer_block", "fwd_with_h"):
        shapes = table[name][4]
        assert shapes[0] == MIXER_B16
        assert set(cs.MIXER_ROUTE_SHAPES) <= set(shapes)
    token_routes = [(s[2] % 8 == 0, s[2] % 8 == s[3] % 8 == 0) for s in cs.MIXER_ROUTE_SHAPES]
    assert token_routes == [(True, True), (True, False), (False, False)]
    assert cs.MIXER_ROUTE_SHAPES[0][1] % 8 != 0  # a ragged N on the wgmma route


def _c_params(fn, source):
    """Names of C entry ``fn``'s parameters in ``source`` (under csrc/)."""
    with open(os.path.join(_build._CSRC, source)) as f:
        text = f.read()
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text).group(1)
    return [re.split(r"[\s*]+", p.strip())[-1] for p in params.split(",")]


def _block(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, N, D, TD, CD = shape
    sizes = [(D,), (D,), (TD, N), (TD,), (N, TD), (N,), (D,), (D,), (CD, D), (CD,), (D, CD), (D,)]
    x = torch.randn((B, N, D), generator=g).bfloat16()
    return x, [torch.randn(s, generator=g).bfloat16() for s in sizes]


def _record(monkeypatch, mod):
    calls = []
    monkeypatch.setattr(mod._LIB, "launch",
                        lambda fn, device, tensors, ints: calls.append((fn, tensors, ints)))
    return calls


def _check_call(lib, source, call, shape):
    """The recorded launch against the C entry: counts as the Library table
    gives them, each pointer's tensor of the shape its parameter name says."""
    fn, tensors, ints = call
    B, N, D, TD, CD = shape
    assert (len(tensors), len(ints)) == lib.functions[fn]
    names = _c_params(fn, source)
    assert names[-1] == "stream_ptr" and len(names) == len(tensors) + len(ints) + 1
    want = {"x": (B, N, D), "ln1w": (D,), "ln1b": (D,), "wt1": (TD, N), "bt1": (TD,),
            "wt2": (N, TD), "bt2": (N,), "ln2w": (D,), "ln2b": (D,), "wc1": (CD, D),
            "bc1": (CD,), "wc2": (D, CD), "bc2": (D,), "xn": (B, N, D), "t": (B, TD, D),
            "wt1p": (TD, -(-N // 8) * 8), "h": (B, N, D), "c": (B * N, CD), "out": (B, N, D),
            "partial": (B, N, D)}
    got = {n: tuple(t.shape) for n, t in zip(names, tensors)}
    assert got == {n: want[n] for n in names[:len(tensors)]}
    assert dict(zip(names[len(tensors):], ints)) == dict(zip(("B", "N", "D", "TD", "CD"), shape))
    assert all(t.is_contiguous() for t in tensors)
    return dict(zip(names, tensors))


@pytest.mark.parametrize("shape", [MIXER_B16[:1] + (33, 16, 24, 32), (2, 20, 16, 8, 24)])
def test_kernel_one_launch_gives_the_padded_wt1_scratch(monkeypatch, shape):
    monkeypatch.setattr(tmb, "LAUNCHES", tmb.LAUNCHES)
    calls = _record(monkeypatch, tmb)
    x, w = _block(shape)
    out = tmb._launch(x, *w)
    (call,) = calls
    assert call[0] == "mixer_block_bf16"
    args = _check_call(tmb._LIB, "mixer_block.cu", call, shape)
    assert args["out"] is out and args["x"] is x


def test_split_entry_launch_gives_the_padded_wt1_scratch(monkeypatch):
    shape = (3, 33, 16, 24, 32)
    monkeypatch.setattr(tmb, "TP_LAUNCHES", tmb.TP_LAUNCHES)
    calls = _record(monkeypatch, tmb)
    x, w = _block(shape)
    h, partial = tmb._launch_partial(x, *w[:-1])
    (call,) = calls
    assert call[0] == "mixer_block_bf16_tp"
    args = _check_call(tmb._LIB, "mixer_block.cu", call, shape)
    assert args["h"] is h and args["partial"] is partial
    assert partial.dtype == torch.float32


def test_fwd_with_h_launch_gives_the_padded_wt1_scratch(monkeypatch):
    shape = (2, 33, 16, 24, 32)
    monkeypatch.setattr(tbwd, "LAUNCHES", dict(tbwd.LAUNCHES))
    monkeypatch.setattr(tbwd, "_device", lambda x, what: "cuda")
    calls = _record(monkeypatch, tbwd)
    x, w = _block(shape)
    out, h = tbwd.fwd_with_h(x, *w)
    (call,) = calls
    assert call[0] == "mixer_fwd_with_h_bf16"
    args = _check_call(tbwd._LIB, "mixer_block_bwd.cu", call, shape)
    assert args["out"] is out and args["h"] is h


def test_forward_scratch_shapes():
    x = torch.empty((2, 196, 24), dtype=torch.bfloat16)
    xn, t, wt1p, h, c = tmb.forward_scratch(x, 40, 56)
    assert [tuple(v.shape) for v in (xn, t, wt1p, h, c)] == [
        (2, 196, 24), (2, 40, 24), (40, 200), (2, 196, 24), (392, 56)]
    assert all(v.dtype == torch.bfloat16 for v in (xn, t, wt1p, h, c))


@pytest.mark.parametrize("label", [k for k, v in mutation_check.MUTANTS.items() if v[1]])
def test_each_mutant_breaks_one_line_of_its_source(label):
    _, path, old, new = mutation_check.MUTANTS[label]
    with open(os.path.join(os.path.dirname(_build._CSRC), path)) as f:
        text = f.read()
    assert text.count(old) == 1 and old != new, label
