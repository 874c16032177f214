"""The GEMM core's handoff schedule, without a card.

``csrc/gemm_sm90.cuh`` runs a bf16 product with a K-major A (``sm90::gemm_tn``,
one product; ``sm90::gemm_bf16``, batch entries and an N-major B) on one of
two schedules, chosen at compile time at each call site: the cooperative one
(three consumer warpgroups on one 192×192 tile, then all three in the
epilogue) or the handoff one (one MMA warpgroup's K loops back to back on
128×192 tiles, each tile's sums handed through shared memory to eleven
epilogue warps that run the functor under the next tile's ``wgmma``s).
Kernel 1's GELU channel product and the lab's, which split kernel 1's time,
the split entry's f32 partial, and the bf16 gMLP and ResMLP blocks' GELU
and token products take the handoff schedule (the token products in its
batched mode: an entry an image, M = 196 tokens cut 128 + 68); kernel 1's
residual product, its token pair, the gMLP and ResMLP blocks' last
products and the Mixer backwards keep the cooperative one.
chip_smoke.py's ``TN_SCHEDULES`` and ``BF16_SCHEDULES`` state which site
runs which, and its phases count the launches by mode on the card; here
the tables are held to the call sites in ``csrc/``, a model of the batched
walk to the kernel's rules, phase 2's shapes to the corners of the
schedule's tile walk, and the checking wrappers' ``core`` values to their
C entries, through a launch that only records them.
"""

import inspect
import os
import re

import pytest
import torch

import chip_smoke as cs
from jittor_mlp_tpu_torch.ops.kernels import _build
from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90 as g
from jittor_mlp_tpu_torch.ops.kernels import gmlp_block as tgb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block_bwd as tbwd
from jittor_mlp_tpu_torch.ops.kernels import resmlp_block as trb
from jittor_mlp_tpu_torch.tools import handoff_variants

CSRC = _build._CSRC
_CALL = re.compile(r"sm90::gemm_tn(<sm90::Sched::(\w+)>)?\(")
# gemm_bf16<TA, TB> or gemm_bf16<TA, TB, sm90::Sched::S>, a call's opening
_BF16_CALL = re.compile(r"sm90::gemm_bf16<(?:true|false), (?:true|false)(, sm90::Sched::(\w+))?>\(")
SMS = 132  # an H100 SXM's multiprocessors: the core's grid


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _header_int(name):
    """A constexpr int of gemm_sm90.cuh."""
    return int(re.search(rf"\b{name} = (\d+)", _read("gemm_sm90.cuh")).group(1))


def _sites(call=_CALL):
    """file → the schedule of each gemm_tn call (or of each ``call``), in
    source order, over the kernel sources (the core's own files define it)."""
    sites = {}
    for name in sorted(os.listdir(CSRC)):
        if not name.endswith((".cu", ".cuh")) or name.startswith("gemm_sm90."):
            continue
        found = [{"Handoff": "handoff", None: "coop"}[m.group(2)]
                 for m in call.finditer(_read(name))]
        if found:
            sites[name] = tuple(found)
    return sites


def test_schedule_table_matches_the_call_sites():
    assert _sites() == cs.TN_SCHEDULES
    assert _sites(_BF16_CALL) == cs.BF16_SCHEDULES


def test_kernel_one_and_the_lab_take_one_schedule_and_the_other_blocks_the_old():
    sched, bf16 = cs.TN_SCHEDULES, cs.BF16_SCHEDULES
    assert sched["mixer_forward.cuh"][0] == "handoff"  # the GELU product
    for lab in ("lab_ablate.cu", "lab_tokmajor.cu", "lab_wide.cu"):
        assert sched[lab] == sched["mixer_forward.cuh"], lab
    # the gMLP and ResMLP blocks: the GELU product and the token product on
    # the handoff schedule, the last product on the cooperative one
    for name in ("resmlp_block.cu", "gmlp_block.cu"):
        assert sched[name] == ("handoff", "coop"), name
        assert bf16[name] == ("handoff",), name
    # kernel 1's token pair and the Mixer backwards keep the cooperative one
    assert set(sched["mixer_block_bwd.cu"]) == set(bf16["mixer_block_bwd.cu"]) == {"coop"}
    assert bf16["mixer_forward.cuh"] == ("coop", "coop")


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(CSRC)
                                        if n.endswith((".cu", ".cuh"))
                                        and not n.startswith("gemm_sm90.")))
def test_only_gemm_tn_calls_name_the_handoff_schedule(name):
    # no other product (gemm_bf16's dual and Group modes, the s8 ones) takes
    # the schedule: each mention of it is a gemm_tn or a gemm_bf16 call's
    # argument
    text = _read(name)
    assert text.count("Sched::Handoff") == len(
        [m for call in (_CALL, _BF16_CALL) for m in call.finditer(text) if m.group(2)]), name


def test_launches_by_mode_a_forward():
    n = cs.HANDOFF_FWD
    assert n == cs.TN_SCHEDULES["mixer_forward.cuh"].count("handoff")
    assert cs.fwd_modes(cs.DEPTH) == {"plain": (4 - n) * cs.DEPTH, "handoff": n * cs.DEPTH}
    assert cs.fwd_modes(cs.DEPTH)["plain"] >= 2 * cs.DEPTH  # the token products
    assert cs.BWD_MODES["fwd_with_h"] == {"handoff": n}
    assert cs.HANDOFF_TP == 1 + cs.TN_SCHEDULES["mixer_block.cu"].count("handoff")
    # the bf16 gMLP and ResMLP blocks: two handoff launches and one plain a
    # block, 60 and 48 handoff launches a gMLP-S and a ResMLP-S24 forward
    for lib in ("gmlp_block", "resmlp_block"):
        assert cs.BLOCK_MODES[lib] == {"plain": 1, "handoff": 2}, lib
        assert sum(cs.BLOCK_MODES[lib].values()) == cs.BLOCK_PRODUCTS[lib][1], lib
    assert cs.BLOCK_MODES["gmlp_block"]["handoff"] * cs.GMLP_DEPTH == 60
    assert cs.BLOCK_MODES["resmlp_block"]["handoff"] * cs.RES_DEPTH == 48


def test_mode_tables_match_the_core_enum():
    enum = re.search(r"enum class Mode \{([^}]*)\}", _read("gemm_sm90.cuh")).group(1)
    values = {k.strip(): int(v) for k, v in re.findall(r"(\w+) = (\d+)", enum)}
    assert values == {"Plain": 0, "Chunked": 1, "Dual": 2, "Group": 3, "Handoff": 4}
    assert _header_int("MODES") == len(values)
    by_name = {"plain": 0, "chunked": 1, "dual": 2, "group": 3, "handoff": 4}
    for modes in (g.MODES, tmb.MODES, tbwd.MODES, tgb.MODES, trb.MODES):
        assert all(by_name[k] == v for k, v in modes.items()), modes
    assert tmb.MODES == tgb.MODES == trb.MODES == {"plain": 0, "handoff": 4}
    assert tbwd.MODES["handoff"] == 4


def test_mode_launches_read_without_loading_the_libraries():
    for mod in (g, tmb, tgb, trb):
        if mod._LIB.loaded:
            pytest.fail("the CPU tests must not load the kernel library")
        assert mod.mode_launches() == dict.fromkeys(mod.MODES, 0)
        assert not mod._LIB.loaded
    assert g._LIB.queries["gemm_mode_launches"] == 1
    assert tmb._LIB.queries["mixer_mode_launches"] == 1
    assert tgb._LIB.queries["gmlp_mode_launches"] == 1
    assert trb._LIB.queries["resmlp_mode_launches"] == 1


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
    if call not in ("gemm_tn", "gemm_bf16"):  # the handoff schedule is theirs alone
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
    # the header's dispatch: gemm_tn is gemm_bf16's one entry; the handoff kernel where the
    # wgmma core runs, else the WMMA core (only on Core::Auto with operands TMA cannot load,
    # or Legacy)
    head = _read("gemm_sm90.cuh")
    tn = head.split("cudaError_t gemm_tn(", 1)[1].split("\n}\n", 1)[0]
    assert "return gemm_bf16<false, false, S>(stream, 1, M, N, K, K," in tn
    bf = head.split("cudaError_t gemm_bf16(", 1)[1].split("\n}\n", 1)[0]
    at = bf.index("core == Core::Sm90 || (core == Core::Auto && tma_ok<bf16>(a) && "
                  "tma_ok<bf16>(b))")
    assert bf.index("return launch_handoff<TB>(", at) < bf.index("bf16gemm::", at)
    launch = head.split("cudaError_t launch_handoff(", 1)[1].split("\n}\n", 1)[0]
    assert "return cudaErrorInvalidValue" in launch and "gemm_bf16" not in launch


# A model of the batched handoff mode's tile walk (gemm_handoff_kernel), from
# the header's constants: the grid, each block's tiles (handoff_pos: entry,
# then column slab, then row tile where B is batched), the producer's K steps
# and maps per tile (operand_maps: a 3-D map of K rows an entry for every
# entry but the last, a 2-D one of K_last rows at the last entry's base), and
# the epilogue warps' items (8 rows × 4 runs of 8 columns, one lane a run).
def _walk(nz, M, N, K, K_last, b_batched, sms=SMS):
    bm, bn, bk = _header_int("HO_BM"), _header_int("HO_BN"), _header_int("K_BYTES") // 2
    warps = 4 * _header_int("HO_EPI_WGS") + 3
    tiles_m, tiles_n = -(-M // bm), -(-N // bn)
    tiles = nz * tiles_m * tiles_n
    handed, boxes, row_tiles = [], [], set()
    for block in range(min(tiles, sms)):
        for tile in range(block, tiles, min(tiles, sms)):
            per = tiles_m * tiles_n
            r = tile % per
            if b_batched:  # rows inner: an entry's column slab serves its row tiles
                z, m0, n0 = tile // per, r % tiles_m * bm, r // tiles_m * bn
            else:
                z, m0, n0 = tile // per, r // tiles_n * bm, r % tiles_n * bn
            row_tiles.add((m0, min(M, m0 + bm) - m0))
            kz = K_last if z == nz - 1 else K
            last = z == nz - 1
            for kt in range(-(-kz // bk)):
                # B's box: through the 2-D map (entry nz - 1's base, K_last rows)
                # or entry z of the 3-D map (K rows an entry, nz - 1 entries)
                entry, rows = (nz - 1, K_last) if (not b_batched or last) else (z, K)
                boxes.append((z, entry, kt * bk, min(rows, kt * bk + bk)))
            for e in range(warps):
                for item in range(e, bm // 8 * (bn // 32), warps):
                    for lane in range(32):
                        row = item // (bn // 32) * 8 + lane // 4
                        col = item % (bn // 32) * 32 + 8 * (lane % 4)
                        gm, gn = m0 + row, n0 + col
                        if gm < M and gn < N:
                            handed += [(z, gm, n) for n in range(gn, min(N, gn + 8))]
    return handed, boxes, row_tiles


# the last case on a grid of 4 blocks: blocks of several tiles, as the
# gMLP-S token product's 4,096 tiles take on 132
@pytest.mark.parametrize("nz, M, N, K, K_last, sms", [(3, 196, 400, 196, 196, SMS),
                                                      (2, 129, 72, 40, 40, SMS),
                                                      (1, 64, 200, 136, 136, SMS),
                                                      (4, 196, 384, 196, 100, SMS),
                                                      (5, 196, 400, 196, 196, 4)])
def test_batched_handoff_walk_hands_every_element_once_and_reads_each_entry_in_its_rows(
        nz, M, N, K, K_last, sms):
    handed, boxes, row_tiles = _walk(nz, M, N, K, K_last, b_batched=True, sms=sms)
    assert len(handed) == len(set(handed)) == nz * M * N  # every (z, m, n) exactly once
    assert set(handed) == {(z, m, n) for z in range(nz) for m in range(M) for n in range(N)}
    if M == 196:  # 196 tokens: a row tile of 128 and one of 68, not 192 + 4
        assert row_tiles == {(0, 128), (128, 68)}
    for z, entry, k0, k_end in boxes:
        # each box reads entry z's own matrix, within that entry's K rows
        assert entry == z
        assert k_end <= (K_last if z == nz - 1 else K)
        assert k0 < k_end


def test_batched_handoff_walk_takes_an_entrys_row_tiles_back_to_back():
    # where B is batched, tiles 2j and 2j + 1 are the two row tiles of one
    # (entry, column slab), on neighbouring blocks of one wave: B's slab is
    # read from device memory once; a shared B keeps the column slabs inner
    def order(b_batched):
        tiles = []
        for tile in range(2 * 3 * 2):
            per, r = 2 * 3, tile % (2 * 3)
            tiles.append((tile // per, r % 2, r // 2) if b_batched else
                         (tile // per, r // 3, r % 3))
        return tiles
    assert order(True)[:4] == [(0, 0, 0), (0, 1, 0), (0, 0, 1), (0, 1, 1)]
    assert order(False)[:4] == [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0)]
    walk = _read("gemm_sm90.cuh").split("TilePos handoff_pos(", 1)[1].split("\n}\n", 1)[0]
    assert "return {tile / per, r % tiles_m * HO_BM, r / tiles_m * HO_BN};" in walk
    kernel = _read("gemm_sm90.cuh").split("gemm_handoff_kernel(", 1)[1].split("\n}\n", 1)[0]
    assert "const bool rows_inner = b_batched;" in kernel
    assert "const bool last = p.z == nz - 1;" in kernel
    assert "epi(p.z, gm, gn, v, min(8, N - gn));" in kernel


def test_phase_two_turns_the_batched_modes_corners():
    shapes = cs.HANDOFF_BATCHED
    ms = {M for _, M, *_ in shapes}
    assert {196, 128, 129, 64} <= ms  # 128 + 68, one tile, a one-row tail, half a tile
    assert any(N % 192 for _, _, N, *_ in shapes)  # a ragged last column slab
    assert any(nz == 1 for nz, *_ in shapes)  # one entry: the 2-D maps alone
    assert any(K % 64 for _, _, _, K, *_ in shapes)  # a K tail in a part of a step
    assert any(not b_mn for *_, b_mn, _ in shapes)  # a K-major batched B
    assert any(lda > K for _, _, _, K, lda, *_ in shapes)  # an A view with rows past K
    # the bf16 gMLP-S and ResMLP-S24 token products at B = 8 and b256
    for nz in (8, 256):
        for cols in (1536, 384):
            assert (nz, 196, cols, 196, 200, True) in [s[:6] for s in shapes]
    # every batched B is one TMA loads: N-major rows of N, K-major of K, 16-byte multiples
    assert all((N if b_mn else K) % 8 == 0 for _, _, N, K, _, b_mn, _ in shapes)


@pytest.mark.parametrize("b_mn", [False, True])
def test_bf16_handoff_core_returns_the_twin_on_the_cpu_and_passes_core_3(b_mn):
    gen = torch.Generator().manual_seed(1)
    a = torch.randn((20, 40), generator=gen).bfloat16()
    b = torch.randn((3, 40, 24) if b_mn else (3, 24, 40), generator=gen).bfloat16()
    before = g.LAUNCHES
    got = g.gemm_bf16(a, b, b_mn=b_mn, core="handoff")
    assert torch.equal(got, g.gemm_bf16_ref(a, b, b_mn=b_mn)) and tuple(got.shape) == (3, 20, 24)
    assert g.LAUNCHES == before and not g._LIB.loaded
    # on the card, the wrapper passes the C entry TN_CORES' code: 3 for "handoff"
    src = inspect.getsource(g.gemm_bf16)
    assert "TN_CORES[core]))" in src and g.TN_CORES["handoff"] == 3


def test_the_handoff_core_refuses_an_mn_major_a():
    a = torch.zeros((40, 20), dtype=torch.bfloat16)
    b = torch.zeros((40, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K-major a"):
        g.gemm_bf16(a, b, a_mn=True, b_mn=True, core="handoff")
    # and so does the C entry: core 3 with a_mn is an invalid value
    body = _read("gemm_sm90.cu").split('extern "C" int gemm_bf16_f32(', 1)[1].split("\n}\n", 1)[0]
    assert "(valid_core(core) || (handoff && !a_mn))" in body
    assert "sm90::gemm_bf16<false, true, sm90::Sched::Handoff>" in body
    assert "sm90::gemm_bf16<false, false, sm90::Sched::Handoff>" in body


@pytest.mark.parametrize("name", list(handoff_variants.VARIANTS))
def test_each_handoff_variant_changes_text_its_sources_hold(name):
    # tools/handoff_variants.py times copies of the port with these edits;
    # each text it replaces must be in its source once
    edits, _ = handoff_variants.VARIANTS[name]
    for path, old, new in edits:
        text = _read(os.path.basename(path))
        assert text.count(old) == 1 and old != new, (name, path, old[:60])
