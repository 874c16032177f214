"""The GEMM core's handoff schedule, without a card.

``csrc/gemm_sm90.cuh`` runs a K-major bf16 product (``sm90::gemm_tn``) on
one of two schedules, chosen at compile time at each call site: the
cooperative one (three consumer warpgroups on one 192×192 tile, then all
three in the epilogue) or the handoff one (one MMA warpgroup's K loops back
to back on 128×192 tiles, each tile's sums handed through shared memory to
eleven epilogue warps that run the functor under the next tile's
``wgmma``s). Kernel 1's GELU channel product and the lab's, which split
kernel 1's time, and the split entry's f32 partial take the handoff
schedule; kernel 1's residual product and the other blocks keep the
cooperative one. chip_smoke.py's ``TN_SCHEDULES`` states which site runs
which, and its phases count the launches by mode on the card; here the
table is held to the call sites in ``csrc/``, phase 2's shapes to the
corners of the schedule's tile walk, and the checking wrapper's ``core``
values to its C entry, through a launch that only records them.
"""

import os
import re

import pytest
import torch

import chip_smoke as cs
from jittor_mlp_tpu_torch.ops.kernels import _build
from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90 as g
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block_bwd as tbwd

CSRC = _build._CSRC
_CALL = re.compile(r"sm90::gemm_tn(<sm90::Sched::(\w+)>)?\(")
SMS = 132  # an H100 SXM's multiprocessors: the core's grid


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _header_int(name):
    """A constexpr int of gemm_sm90.cuh."""
    return int(re.search(rf"\b{name} = (\d+)", _read("gemm_sm90.cuh")).group(1))


def _sites():
    """file → the schedule of each gemm_tn call, in source order, over the
    kernel sources (the core's own files define it)."""
    sites = {}
    for name in sorted(os.listdir(CSRC)):
        if not name.endswith((".cu", ".cuh")) or name.startswith("gemm_sm90."):
            continue
        found = [{"Handoff": "handoff", None: "coop"}[m.group(2)]
                 for m in _CALL.finditer(_read(name))]
        if found:
            sites[name] = tuple(found)
    return sites


def test_schedule_table_matches_the_call_sites():
    assert _sites() == cs.TN_SCHEDULES


def test_kernel_one_and_the_lab_take_one_schedule_and_the_other_blocks_the_old():
    sched = cs.TN_SCHEDULES
    assert sched["mixer_forward.cuh"][0] == "handoff"  # the GELU product
    for lab in ("lab_ablate.cu", "lab_tokmajor.cu", "lab_wide.cu"):
        assert sched[lab] == sched["mixer_forward.cuh"], lab
    for name in ("resmlp_block.cu", "gmlp_block.cu", "mixer_block_bwd.cu"):
        assert set(sched[name]) == {"coop"}, name


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(CSRC)
                                        if n.endswith((".cu", ".cuh"))
                                        and not n.startswith("gemm_sm90.")))
def test_only_gemm_tn_calls_name_the_handoff_schedule(name):
    # no other product (gemm_bf16, its dual and Group modes, the s8 ones)
    # takes the schedule: each mention of it is a gemm_tn call's argument
    text = _read(name)
    assert text.count("Sched::Handoff") == len(
        [m for m in _CALL.finditer(text) if m.group(2)]), name


def test_launches_by_mode_a_forward():
    n = cs.HANDOFF_FWD
    assert n == cs.TN_SCHEDULES["mixer_forward.cuh"].count("handoff")
    assert cs.fwd_modes(cs.DEPTH) == {"plain": (4 - n) * cs.DEPTH, "handoff": n * cs.DEPTH}
    assert cs.fwd_modes(cs.DEPTH)["plain"] >= 2 * cs.DEPTH  # the token products
    assert cs.BWD_MODES["fwd_with_h"] == {"handoff": n}
    assert cs.HANDOFF_TP == 1 + cs.TN_SCHEDULES["mixer_block.cu"].count("handoff")


def test_mode_tables_match_the_core_enum():
    enum = re.search(r"enum class Mode \{([^}]*)\}", _read("gemm_sm90.cuh")).group(1)
    values = {k.strip(): int(v) for k, v in re.findall(r"(\w+) = (\d+)", enum)}
    assert values == {"Plain": 0, "Chunked": 1, "Dual": 2, "Group": 3, "Handoff": 4}
    assert _header_int("MODES") == len(values)
    by_name = {"plain": 0, "chunked": 1, "dual": 2, "group": 3, "handoff": 4}
    for modes in (g.MODES, tmb.MODES, tbwd.MODES):
        assert all(by_name[k] == v for k, v in modes.items()), modes
    assert tmb.MODES == {"plain": 0, "handoff": 4}
    assert tbwd.MODES["handoff"] == 4


def test_mode_launches_read_without_loading_the_libraries():
    for mod in (g, tmb):
        if mod._LIB.loaded:
            pytest.fail("the CPU tests must not load the kernel library")
        assert mod.mode_launches() == dict.fromkeys(mod.MODES, 0)
        assert not mod._LIB.loaded
    assert g._LIB.queries["gemm_mode_launches"] == 1
    assert tmb._LIB.queries["mixer_mode_launches"] == 1


def test_the_schedules_tile_ring_and_registers_fit_the_card():
    bm, bn, stages = _header_int("HO_BM"), _header_int("HO_BN"), _header_int("HO_STAGES")
    assert (bm, bn, stages) == (128, 192, 3)
    stage = (bm + bn) * 128  # a K step: 128 bytes of each operand row
    sums = bm * (bn + 8) * 4  # the tile's f32 sums, rows padded by 8 floats
    smem = 1024 + stages * stage + sums + (2 * stages + 2) * 8
    assert stage == 40 * 1024 and smem <= 232448
    # the MMA warps' float2 stores of a half-warp (rows r < 4, lanes q < 4)
    # land in 32 distinct banks of a row (bn + 8) floats long
    assert len({(r * (bn + 8) + 2 * q + c) % 32
                for r in range(4) for q in range(4) for c in range(2)}) == 32
    # setmaxnreg within the 512 × 128 registers the launch bounds give: the
    # producer warpgroup 72, the MMA warpgroup 232 (192 sums), two epilogue
    # warpgroups 104
    regs = {"producer": _header_int("HO_PRODUCER_REGS"), "mma": _header_int("HO_MMA_REGS")}
    epi = (512 * 128 - 128 * (regs["producer"] + regs["mma"])) // 256 // 8 * 8
    assert (regs["producer"], regs["mma"], epi) == (72, 232, 104)
    assert 128 * (regs["producer"] + regs["mma"]) + 256 * epi <= 512 * 128
    assert regs["mma"] - bn >= 40  # the 192 sums and room for the K loop
    # eleven epilogue warps: two warpgroups and the producer warpgroup's warps 1-3
    assert _header_int("HO_EPI_WGS") == 2


def _tiles(M, N):
    return -(-M // 128) * -(-N // 192)


def test_phase_two_turns_the_schedules_corners():
    shapes = cs.GEMM_SHAPES + cs.HANDOFF_SHAPES
    # ragged M and N against the 128×192 tile, with a K tail
    assert any(M % 128 and N % 192 and K % 64 for M, N, K in shapes)
    # blocks of several tiles, an odd count among them: the sums' buffer
    # and its two barriers turn more than once, in both parities
    assert any(_tiles(M, N) > 2 * SMS for M, N, _ in shapes)
    assert any(_tiles(M, N) % 2 == 1 and _tiles(M, N) > SMS for M, N, _ in shapes)
    # fewer tiles than multiprocessors: blocks of one tile
    assert any(_tiles(M, N) < SMS for M, N, _ in shapes)
    assert any(SMS < _tiles(M, N) < 2 * SMS for M, N, _ in shapes)
    # every shape is one the wgmma core loads (rows 16-byte multiples)
    assert all(K % 8 == 0 for _, _, K in shapes)


def _operands(M=20, N=24, K=40, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((M, K), generator=gen).bfloat16()
    b = torch.randn((N, K), generator=gen).bfloat16()
    bias = torch.randn((N,), generator=gen).bfloat16()
    r = torch.randn((M, N), generator=gen).bfloat16()
    return a, b, bias, r


@pytest.mark.parametrize("core", sorted(g.TN_CORES))
@pytest.mark.parametrize("residual", [False, True])
def test_every_core_returns_the_twin_on_the_cpu(core, residual):
    a, b, bias, r = _operands()
    kw = {"residual": r} if residual else {"act": "gelu_tanh"}
    before = g.LAUNCHES
    got = g.gemm_tn(a, b, bias, core=core, **kw)
    assert torch.equal(got, g.gemm_tn_ref(a, b, bias, **kw))
    assert g.LAUNCHES == before and not g._LIB.loaded


@pytest.mark.parametrize("call", ["gemm_tn", "gemm_bf16", "gemm_bf16_dual", "gemm_bf16_group",
                                  "gemm_s8"])
def test_unknown_core_raises(call):
    a, b, bias, _ = _operands()
    args = {"gemm_tn": lambda core: g.gemm_tn(a, b, bias, act="gelu_tanh", core=core),
            "gemm_bf16": lambda core: g.gemm_bf16(a, b, core=core),
            "gemm_bf16_dual": lambda core: g.gemm_bf16_dual(a, b, a, b, core=core),
            "gemm_bf16_group": lambda core: g.gemm_bf16_group(a[None], b[None], 1, core=core),
            "gemm_s8": lambda core: g.gemm_s8(
                torch.zeros((4, 32), dtype=torch.int8), torch.zeros((8, 32), dtype=torch.int8),
                torch.ones(4), torch.ones(8), core=core)}[call]
    with pytest.raises(ValueError, match="core must be one of"):
        args("wgmma")
    if call != "gemm_tn":  # the handoff schedule is gemm_tn's alone
        with pytest.raises(ValueError, match="core must be one of"):
            args("handoff")


@pytest.mark.parametrize("core", sorted(g.TN_CORES))
@pytest.mark.parametrize("residual", [False, True])
def test_recorded_launch_passes_the_core_code(monkeypatch, core, residual):
    calls = []
    monkeypatch.setattr(g._LIB, "launch",
                        lambda fn, device, tensors, ints: calls.append((fn, tensors, ints)))
    monkeypatch.setattr(g, "LAUNCHES", g.LAUNCHES)
    before = g.LAUNCHES
    a, b, bias, r = _operands(M=33, N=24, K=40)
    out = g._launch_tn(a, b, bias, r if residual else None, core)
    ((fn, tensors, ints),) = calls
    assert fn == "gemm_tn_bf16"
    assert (len(tensors), len(ints)) == g._LIB.functions[fn]
    names = re.search(r'extern "C" int gemm_tn_bf16\(([^)]*)\)', _read("gemm_sm90.cu")).group(1)
    names = [re.split(r"[\s*]+", p.strip())[-1] for p in names.split(",")]
    args = dict(zip(names, list(tensors) + list(ints)))
    assert args["c"] is out and tuple(out.shape) == (33, 24)
    assert args["r"] is (r if residual else out)
    assert (args["M"], args["N"], args["K"], args["act"]) == (33, 24, 40, int(residual))
    assert args["core"] == g.TN_CORES[core]
    assert g.LAUNCHES == before + 1


def test_the_c_entry_runs_core_3_on_the_handoff_schedule_and_never_falls_back():
    body = _read("gemm_sm90.cu").split('extern "C" int gemm_tn_bf16(', 1)[1].split("\n}\n", 1)[0]
    assert g.TN_CORES == {"auto": 0, "sm90": 1, "legacy": 2, "handoff": 3}
    at = body.index("if (core == 3)")
    assert "channel_product<sm90::Sched::Handoff>" in body[at:at + 200]
    assert "sm90::Core::Sm90" in body[at:at + 300]  # an error where TMA's rules fail
    # the header's dispatch: the handoff kernel where the wgmma core runs, else gemm_bf16's
    # routes (the WMMA core only on Core::Auto with operands TMA cannot load, or Legacy)
    head = _read("gemm_sm90.cuh")
    tn = head.split("cudaError_t gemm_tn(", 1)[1].split("\n}\n", 1)[0]
    assert "core == Core::Sm90 || (core == Core::Auto && tma_ok<bf16>(a) && tma_ok<bf16>(b))" in tn
    assert "return launch_handoff(" in tn
    launch = head.split("cudaError_t launch_handoff(", 1)[1].split("\n}\n", 1)[0]
    assert "return cudaErrorInvalidValue" in launch and "gemm_bf16" not in launch
