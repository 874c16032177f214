"""The kernel lab's GEMM routes and its wrappers' launch arguments, without
a card.

The lab's three CUDA sources run their four products through kernel 1's
code: the token pair through ``csrc/mixer_forward.cuh``'s
``token_products``, the channel pair through ``gemm_tn``. Each product
takes the wgmma core where TMA can load both operands (every row stride a
multiple of 16 bytes), else the WMMA core. The token products' B operands
are W columns wide: bt images side by side (W = bt·D) in the wide and
token-major kernels, one image (W = D) in the ablate and no-scratch ones;
Wt1 is copied into rows of round_up(N, 8). chip_smoke.py's ``LAB_ROUTED``
states the rule and its phase 2 holds the kernels' counts to it on the
card; here the table is held to the operands' strides, ``LAB_SHAPES`` to
the route cases, each wrapper's launch arguments to its C entry's
parameters through a launch that only records them, and the lab's mutants
to their sources.
"""

import os
import re

import pytest
import torch

import chip_smoke as cs
from jittor_mlp_tpu_torch.ops.kernels import _build
from jittor_mlp_tpu_torch.ops.kernels import kernel_lab as tkl
from jittor_mlp_tpu_torch.tools import kernel_lab as lab
from jittor_mlp_tpu_torch.tools import mutation_check

WIDE = ("tokmajor_block", "wide_block")  # bt images side by side in the token products
# (wrapper, shape, bt) of every call phase 2 makes
CALLS = [(fn, shape, kw["bt"]) for fn in cs.LAB_KERNELS for shape in cs.LAB_SHAPES
         for kw in cs.lab_variants(fn).values()]


def _rule(fn, shape, bt):
    """{"sm90": n, "wmma": n} from the four products' operands: the elements
    between rows of (A, B) each, bf16, 16-byte multiples for TMA."""
    _, N, D, TD, CD = shape
    W = bt * D if fn in WIDE else D
    Np = -(-N // 8) * 8
    products = [(Np, W), (TD, W), (D, D), (CD, CD)]
    sm90 = sum(all(2 * ld % 16 == 0 for ld in pair) for pair in products)
    return {"sm90": sm90, "wmma": len(products) - sm90}


@pytest.mark.parametrize("fn, shape, bt", CALLS)
def test_lab_route_table_follows_the_operands_strides(fn, shape, bt):
    assert cs.LAB_ROUTED[fn](shape, bt) == _rule(fn, shape, bt)


def test_lab_route_table_at_mixer_b16():
    shape = lab.N, lab.D, lab.TD, lab.CD
    for fn in cs.LAB_KERNELS:
        for bt in (1, 2, 4, 8):
            assert cs.LAB_ROUTED[fn]((256, *shape), bt) == {"sm90": 4, "wmma": 0}
    # the lab kernels of one image an entry route as kernel 1 does
    for shape in cs.LAB_SHAPES + cs.MIXER_ROUTE_SHAPES:
        for fn in ("noscratch_block", "ablate_block"):
            assert cs.LAB_ROUTED[fn](shape, 2) == cs.ROUTED["fused_mixer_block"](shape)


@pytest.mark.parametrize("fn", list(cs.LAB_KERNELS))
def test_lab_shapes_take_both_cores_in_each_kernels_token_products(fn):
    first = {(shape, bt): cs.LAB_WIDTH[fn](shape, bt) % 8 == 0
             for f, shape, bt in CALLS if f == fn}
    assert set(first.values()) == {True, False}
    assert cs.LAB_SHAPES[0] == (8, lab.N, lab.D, lab.TD, lab.CD)  # the lab's check
    assert cs.LAB_SHAPES[-1] == (256, lab.N, lab.D, lab.TD, lab.CD)  # its stack


def test_a_ragged_lab_shape_routes_by_bt():
    """D = 30: bt·D % 8 != 0 at bt 2 (the WMMA core), == 0 at bt 4 and 8
    (the wgmma core, eight columns of a tile straddling two images); N = 33
    is ragged too (Wt1 in rows of 40)."""
    ragged = [s for s in cs.LAB_SHAPES if len({bt * s[2] % 8 == 0 for bt in (2, 4)}) == 2]
    assert ragged == [(8, 33, 30, 24, 72)]
    shape = ragged[0]
    assert shape[1] % 8 != 0
    for fn in WIDE:
        assert cs.LAB_ROUTED[fn](shape, 2) == {"sm90": 1, "wmma": 3}
        assert cs.LAB_ROUTED[fn](shape, 4) == {"sm90": 3, "wmma": 1}
    assert cs.LAB_ROUTED["wide_block"](shape, 4) == cs.LAB_ROUTED["tokmajor_block"](shape, 8)
    # a wide product on the wgmma core whose eight-column runs straddle images
    assert any(bt * s[2] % 8 == 0 and s[2] % 8 != 0 for s in cs.LAB_SHAPES for bt in (2, 4))
    # TD % 8 != 0: the second token product on WMMA, the other three on the wgmma core
    assert cs.LAB_ROUTED["wide_block"]((8, 33, 136, 50, 200), 2) == {"sm90": 3, "wmma": 1}


def _c_params(fn, source):
    """Names of C entry ``fn``'s parameters in ``source`` (under csrc/)."""
    with open(os.path.join(_build._CSRC, source)) as f:
        text = f.read()
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text).group(1)
    return [re.split(r"[\s*]+", p.strip())[-1] for p in params.split(",")]


def _weights(N, D, TD, CD, seed=0):
    g = torch.Generator().manual_seed(seed)
    sizes = [(D,), (D,), (TD, N), (TD,), (N, TD), (N,), (D,), (D,), (CD, D), (CD,), (D, CD), (D,)]
    return [torch.randn(s, generator=g).bfloat16() for s in sizes]


# wrapper → (its C entry, the keyword arguments of the call)
ENTRIES = {
    "tokmajor_block": ("lab_tokmajor_bf16", {"bt": 4}),
    "wide_block": ("lab_wide_bf16", {"bt": 4}),
    "noscratch_block": ("lab_ablate_bf16", {"bt": 2}),
    "ablate_block": ("lab_ablate_bf16", {"bt": 2, "gelu": "relu", "ln": False}),
}


@pytest.mark.parametrize("name", list(ENTRIES))
@pytest.mark.parametrize("shape", [(8, 33, 30, 24, 72), (4, 20, 16, 8, 24)])
def test_lab_launch_gives_the_padded_wt1_scratch(monkeypatch, name, shape):
    """Through a launch that only records: every pointer the C entry takes,
    each of the shape its parameter name says (Wt1's copy (TD,
    round_up(N, 8))), and the ints it takes in order."""
    entry, kw = ENTRIES[name]
    B, N, D, TD, CD = shape
    bt = kw["bt"]
    lib = tkl._LIBS[name]
    calls = []
    monkeypatch.setattr(tkl, "_device", lambda x: "cuda")
    monkeypatch.setattr(tkl, "LAUNCHES", dict(tkl.LAUNCHES))
    monkeypatch.setattr(lib, "launch",
                        lambda fn, device, tensors, ints: calls.append((fn, tensors, ints)))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((B, N, D), generator=g).bfloat16()
    if name == "tokmajor_block":
        x = tkl.to_tokmajor(x, bt)
    out = getattr(tkl, name)(x, *_weights(N, D, TD, CD), **kw)
    (call,) = calls
    fn, tensors, ints = call
    assert fn == entry and (len(tensors), len(ints)) == lib.functions[fn]
    names = _c_params(fn, cs.LAB_KERNELS[name][0])
    assert names[-1] == "stream_ptr" and len(names) == len(tensors) + len(ints) + 1
    G, W = B // bt, bt * D
    act = {"ablate_block": tkl.GELUS.index("relu"), "noscratch_block": tkl.GELUS.index("exact")}
    want_ints = {
        "tokmajor_block": {"G": G, "N": N, "bt": bt, "D": D, "TD": TD, "CD": CD},
        "wide_block": {"B": B, "N": N, "D": D, "TD": TD, "CD": CD, "bt": bt},
    }.get(name, {"B": B, "N": N, "D": D, "TD": TD, "CD": CD, "act": act.get(name),
                 "ln": int(name == "noscratch_block")})
    assert dict(zip(names[len(tensors):], ints)) == want_ints
    got = {n: (tuple(t.shape), t.dtype) for n, t in zip(names, tensors)}
    bf, f32 = torch.bfloat16, torch.float32
    rows = {"tokmajor_block": (G, N, bt, D)}.get(name, (B, N, D))
    want = {"x": (rows, bf), "ln1w": ((D,), bf), "ln1b": ((D,), bf), "wt1": ((TD, N), bf),
            "bt1": ((TD,), bf), "wt2": ((N, TD), bf), "bt2": ((N,), bf), "ln2w": ((D,), bf),
            "ln2b": ((D,), bf), "wc1": ((CD, D), bf), "bc1": ((CD,), bf), "wc2": ((D, CD), bf),
            "bc2": ((D,), bf), "xn": ((B, N, D), bf), "xg": ((B, N, D), bf),
            "t": ((B, TD, D), bf), "wt1p": ((TD, -(-N // 8) * 8), bf), "h": ((B, N, D), bf),
            "hf": ((B, N, D), f32), "c": ((B * N, CD), bf), "out": (rows, bf)}
    assert got == {n: want[n] for n in names[:len(tensors)]}
    assert G * TD * W == B * TD * D  # t holds G entries of (TD, W)
    args = dict(zip(names, tensors))
    assert args["out"] is out and args["x"] is x
    assert all(t.is_contiguous() for t in tensors)
    # the no-scratch body keeps h in the output buffer
    assert (args["h"] is out) == (name == "noscratch_block")


LAB_SOURCES = ("csrc/lab_tokmajor.cu", "csrc/lab_wide.cu", "csrc/lab_ablate.cu",
               "csrc/lab_block.cuh", "csrc/mixer_forward.cuh")
LAB_MUTANTS = [k for k, (kernels, path, *_rest) in mutation_check.MUTANTS.items()
               if kernels and set(kernels.split(",")) & set(cs.LAB_KERNELS)]


@pytest.mark.parametrize("label", LAB_MUTANTS)
def test_each_lab_mutant_breaks_one_line_of_a_lab_source(label):
    kernels, path, old, new = mutation_check.MUTANTS[label]
    assert path in LAB_SOURCES, label
    with open(os.path.join(os.path.dirname(_build._CSRC), path)) as f:
        assert f.read().count(old) == 1 and old != new, label


def test_lab_mutants_cover_the_new_token_products():
    tags = {label.split()[0] for label in LAB_MUTANTS}
    assert {"M12", "M13", "M36", "M37", "M38"} <= tags
    # M12 reads the token-major group at leading dimension D in the new call
    assert mutation_check.MUTANTS[next(k for k in LAB_MUTANTS if k.startswith("M12 "))][2] == \
        "wt1p, xn, W, nw,"
