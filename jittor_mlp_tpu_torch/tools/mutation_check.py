"""Does chip_smoke.py catch a wrong kernel? Run its kernel phase (2) and,
for the Mixer training kernels, its gradient bands (6b), for the axial
shift its AS-MLP-T gradient bands (6g), for the Mixer block's tensor-parallel
split entry and finishing pass its split-block check (14a), against
deliberately broken copies of the kernels (the kernel lab's and the GEMM
core's modes among them, and the shared GELU, which phase 2 sweeps).

    python -m jittor_mlp_tpu_torch.tools.mutation_check [--only M10,M11]

Run from the repository root on a machine with the card. Each mutant is a
copy of the port and chip_smoke.py under ``build/mutants/`` (listed in
.gitignore) with one line of a CUDA source changed; the checkout itself is
not touched. The copies' libraries build first, ``--jobs`` nvcc at a time,
into one shared directory (a library is named by a hash of its sources and
headers, so one a mutant leaves unchanged builds once).
For each copy it prints phase 2's
max|Δ|/max(1, max|ref|) per shape (the shift: bit-equal or not, per
shape, axis, sign and dtype), the 6b or 6g gradient errors where a
training kernel or the shift is broken, and "would FAIL" where the check
would stop the run. The first copy is unchanged and must pass. ``--only``
runs the unchanged copy and the mutants named (by their "M<n>" tag).
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

MUTANTS = {
    "correct": (None, None, None, None),
    # the mma.sync core's chunk flush: only the core's legacy chunked cases
    # run it (no block kernel runs mma.sync)
    "M1 chunked flush applies chunk 0's row scales": (
        "gemm_core", "csrc/gemm_s8.cuh",
        "if (kend % chunk == 0) flush(kend / chunk - 1);", "if (kend % chunk == 0) flush(0);"),
    "M2 second token mix takes image 0's column scales": (
        "fused_mixer_block_int8", "csrc/mixer_block_int8.cu",
        "Scales{f32(swt2), 0, 1, w.st, D}", "Scales{f32(swt2), 0, 1, w.st, 0}"),
    "M3 bf16 ResMLP output reads gamma2 of the first of 8 columns (its 16-byte path)": (
        "fused_resmlp_block", "csrc/resmlp_block.cu",
        "__fmul_rn(at8(g2v, e), __fadd_rn(v[e], at8(c2v, e)))",
        "__fmul_rn(at8(g2v, 0), __fadd_rn(v[e], at8(c2v, e)))"),
    "M4 W8A8 ResMLP token epilogue's row8 reads h1 of the first of its 8 columns": (
        "fused_resmlp_block_int8", "csrc/resmlp_block_int8.cu",
        "__fmul_rn(at8(xr, e), at8(a1v, e))", "__fmul_rn(at8(xr, 0), at8(a1v, e))"),
    "M5 bf16 gMLP gate reads u at leading dimension F instead of 2F": (
        "fused_gmlp_block", "csrc/gmlp_block.cu", "gate{w.y, F2,", "gate{w.y, F,"),
    "M6 W8A8 gMLP token product takes image 0's column scales for every image": (
        "fused_gmlp_block_int8", "csrc/gmlp_block_int8.cu",
        "Scales{f32(swsp), 0, 1, w.sv, F}", "Scales{f32(swsp), 0, 1, w.sv, 0}"),
    "M7 act' dropped from the GELU-grad epilogue of the channel weight grad's recompute": (
        "chan_wgt_bwd", "csrc/mixer_block_bwd.cu",
        "d[e] = v[e] * gelu_tanh_grad(d[e]);", "d[e] = v[e];"),
    "M8 the m2·x̂ term dropped from the LayerNorm backward": (
        "chan_data_bwd", "csrc/mixer_block_bwd.cu",
        "inv * (dy - m1 - xhat * m2)", "inv * (dy - m1)"),
    "M9 the Group mode's partials sum only the first image of their group": (
        "token_bwd,gemm_core", "csrc/gemm_sm90.cuh",
        "return left < per ? left : per;", "return 1;"),
    "M10 the shift's sign is not flipped: the backward shifts like the forward": (
        "axial_shift", "csrc/axial_shift.cu",
        "return sign * (half - c / group);", "return half - c / group;"),
    "M11 the channel group is C / shift floored, not ceil (differs at C = 20, shift 3)": (
        "axial_shift", "csrc/axial_shift.cu",
        "const int group = (C + shift - 1) / shift;", "const int group = C / shift;"),
    "M12 the token-major first token product reads each group at leading dimension D, not bt·D": (
        "tokmajor_block", "csrc/lab_tokmajor.cu",
        "wt1p, xn, W, nw,", "wt1p, xn, D, nw,"),
    "M13 the ablate kernel runs the tanh GELU where ReLU was asked": (
        "ablate_block", "csrc/lab_ablate.cu",
        "case 3: return run<Act::Relu>(JMT_ARGS);", "case 3: return run<Act::Tanh>(JMT_ARGS);"),
    # the wgmma core (gemm_sm90.cuh): the K-step count is shared by the
    # producer and the consumers, so a step fewer drops a step's product
    # instead of leaving the consumers waiting for a load that never comes
    "M14 the wgmma core loads and multiplies K / step steps, not ceil: a ragged K tail is dropped": (
        "gemm_tn,fused_mixer_block,gemm_core", "csrc/gemm_sm90.cuh",
        "return (kz + step - 1) / step;", "return kz / step;"),
    "M15 the wgmma core's second and third consumer warpgroups write the first one's rows": (
        "gemm_tn,fused_mixer_block,gemm_core", "csrc/gemm_sm90.cuh",
        "const int mrow = p.m0 + c * 64 + warp * 16;", "const int mrow = p.m0 + warp * 16;"),
    # the core's modes of this round: MN-major operands, the batch axis (row
    # slabs of a sum, images of the gMLP token product), the s8 epilogue
    "M16 the transpose bit of an MN-major B is dropped: wgmma reads its tile as K-major": (
        "gemm_core,chan_wgt_bwd,chan_data_bwd", "csrc/gemm_sm90.cuh",
        '"n"(TB ? 1 : 0));', '"n"(0));'),
    "M17 every entry of a batched operand loads the last entry's matrix (no 3-D map)": (
        "gemm_core,chan_wgt_bwd,fused_gmlp_block_int8", "csrc/gemm_sm90.cuh",
        "const bool la = !a_batched || p.z == nz - 1, lb = !b_batched || p.z == nz - 1;",
        "const bool la = true, lb = true;"),
    "M18 dWc1 is summed without its last slab's partial": (
        "chan_wgt_bwd", "csrc/mixer_block_bwd.cu",
        "JMT_CHECK(sum_groups(s, w.pc1, w.slabs, (long long)CD * D, dwc1));",
        "JMT_CHECK(sum_groups(s, w.pc1, w.slabs - 1, (long long)CD * D, dwc1));"),
    "M19 the s8 epilogue scales eight columns by the first one's column scale": (
        "gemm_core,fused_gmlp_block_int8", "csrc/gemm_sm90.cuh",
        "v[e] = __fmul_rn(__fmul_rn(acc[e], rs), cs[e]);",
        "v[e] = __fmul_rn(__fmul_rn(acc[e], rs), cs[0]);"),
    # the core's chunked s8 mode and the bf16 gMLP block's token product
    "M20 the chunked mode's flush scales every chunk by chunk 0's row scale": (
        "gemm_core,fused_mixer_block_int8", "csrc/gemm_sm90.cuh",
        "(long long)m * sc.row_stride + piece]", "(long long)m * sc.row_stride + 0]"),
    "M21 the chunked mode flushes only where a 128-code K step ends (wrong for 544-code chunks)": (
        "gemm_core,fused_mixer_block_int8", "csrc/gemm_sm90.cuh",
        "const int kend = kt * STEP + (k + 1) * KI;", "const int kend = (kt + 1) * STEP;"),
    "M22 the bf16 gMLP token product's TB bit is dropped: vn is read as a K-major B": (
        "fused_gmlp_block", "csrc/gmlp_block.cu",
        "sm90::gemm_bf16<false, true, sm90::Sched::Handoff>(s, B, N, F,",
        "sm90::gemm_bf16<false, false, sm90::Sched::Handoff>(s, B, N, F,"),
    # the ResMLP blocks on the cores
    "M23 the bf16 ResMLP token product's TB bit is dropped: h is read as a K-major B": (
        "fused_resmlp_block", "csrc/resmlp_block.cu",
        "(sm90::gemm_bf16<false, true, sm90::Sched::Handoff>(",
        "(sm90::gemm_bf16<false, false, sm90::Sched::Handoff>("),
    "M24 the W8A8 ResMLP output's row8 reads h2 of the first of its 8 columns": (
        "fused_resmlp_block_int8", "csrc/resmlp_block_int8.cu",
        "__fadd_rn(r[e], __fmul_rn(at8(g2v, e),", "__fadd_rn(r[0], __fmul_rn(at8(g2v, e),"),
    "M25 the bf16 ResMLP's copy of Wt is written at pitch N, not Np": (
        "fused_resmlp_block", "csrc/resmlp_block.cu",
        "cudaMemcpy2DAsync(w.wt, sizeof(bf16) * Np,", "cudaMemcpy2DAsync(w.wt, sizeof(bf16) * N,"),
    # the core's dual and Group modes under the Mixer token and channel data
    # backwards
    "M26 act' dropped from the channel data backward's dual epilogue": (
        "chan_data_bwd", "csrc/mixer_block_bwd.cu",
        "d[e] = v2[e] * gelu_tanh_grad(v1[e] + at8(bv, e));", "d[e] = v2[e];"),
    "M27 act' dropped from the token backward's dual epilogue": (
        "token_bwd", "csrc/mixer_block_bwd.cu",
        "d[e] = v2[e] * gelu_tanh_grad(tp);", "d[e] = v2[e];"),
    "M28 the dual epilogue reads v1 for v2 in each tile's first 32-column run": (
        "gemm_core,token_bwd,chan_data_bwd", "csrc/gemm_sm90.cuh",
        "quad_run(acc2, g, i, q, v2);",
        "quad_run(acc2, g, i, q, v2); if (g == 0) quad_run(acc, g, i, q, v2);"),
    "M29 the copies of Wt2ᵀ and Wc2ᵀ are not transposed": (
        "token_bwd,chan_data_bwd", "csrc/mixer_block_bwd.cu",
        "in[(size_t)r * C + c]", "in[(size_t)c * R + r]"),
    "M30 the Group mode's short last group skips its last image": (
        "token_bwd,gemm_core", "csrc/gemm_sm90.cuh",
        "return left < per ? left : per;", "return left < per ? left - 1 : per;"),
    "M31 the WMMA core's grouped sum takes only the first image of each group": (
        "gemm_core", "csrc/gemm_bf16.cuh",
        "steps = (nimg - 1) * KT + (int)((k_last + BK - 1) / BK);", "steps = KT;"),
    # the tensor-parallel split of the Mixer block (phase 14a)
    "M32 the split entry's f32 partial is stored without its last 64 columns": (
        "fused_mixer_block_tp", "csrc/mixer_block.cu",
        "s, B * N, D, CD, c, CD, wc2, CD, sm90::StoreEntries",
        "s, B * N, D - 64, CD, c, CD, wc2, CD, sm90::StoreEntries"),
    "M33 the finishing pass adds the bias twice": (
        "mixer_block_tp_finish", "csrc/mixer_block.cu",
        "v[e] = at8(hv, e) + (sv[e] + at8(bv, e));",
        "v[e] = at8(hv, e) + (sv[e] + at8(bv, e) + at8(bv, e));"),
    # the token products on the wgmma core (mixer_forward.cuh's
    # token_products, which kernel 1, the forward-with-h, the split entry and
    # the kernel lab's three bodies share)
    "M34 the token products' copy of Wt1 is written at pitch N, not Np": (
        "fused_mixer_block", "csrc/mixer_forward.cuh",
        "cudaMemcpy2DAsync(wt1p, sizeof(bf16) * Np,", "cudaMemcpy2DAsync(wt1p, sizeof(bf16) * N,"),
    "M35 the first token product's TB bit is dropped: xn is read as a K-major B": (
        "fused_mixer_block", "csrc/mixer_forward.cuh",
        "(sm90::gemm_bf16<false, true>(s, nz, TD, W, N, N, wt1p,",
        "(sm90::gemm_bf16<false, false>(s, nz, TD, W, N, N, wt1p,"),
    "M36 the second token product stores no row past 192: h's 4-row M tail is left": (
        "fused_mixer_block,fused_mixer_block_tp,wide_block", "csrc/mixer_forward.cuh",
        "(sm90::gemm_bf16<false, true>(s, nz, N, W, TD, TD, wt2,",
        "(sm90::gemm_bf16<false, true>(s, nz, std::min(N, 192), W, TD, TD, wt2,"),
    # the kernel lab's token products on the wgmma core (lab_*.cu)
    "M37 the wide kernel's scatter of h takes one image for eight columns that straddle two": (
        "wide_block", "csrc/lab_block.cuh",
        "const size_t o = at(z, m, n + e);", "const size_t o = at(z, m, n) + e;"),
    "M38 the wide kernel's token products read group g's xn at entry stride N·D, not N·bt·D": (
        "wide_block", "csrc/lab_wide.cu",
        "wt1p, xg, W, nw,", "wt1p, xg, W, (long long)N * D,"),
    # the core's handoff schedule (gemm_handoff_kernel), which kernel 1's
    # GELU channel product runs: the MMA warpgroup's stores of a tile's
    # sums, its stages and its second m64 half, the epilogue warps' items
    "M39 the handoff schedule stores each tile's second m64 half of sums over its first": (
        "gemm_tn,fused_mixer_block", "csrc/gemm_sm90.cuh",
        "sums + (64 * h + 16 * warp + r + 8 * i) * HO_LD",
        "sums + (16 * warp + r + 8 * i) * HO_LD"),
    "M40 the handoff epilogue hands each lane its item's first 8-column run": (
        "gemm_tn,fused_mixer_block", "csrc/gemm_sm90.cuh",
        "col = item % RUNS * 32 + 8 * q;", "col = item % RUNS * 32;"),
    "M41 the handoff MMA warpgroup multiplies the next ring stage's operands": (
        "gemm_tn,fused_mixer_block", "csrc/gemm_sm90.cuh",
        "smem_u32(smem + s * G::STAGE_BYTES), b = a + G::A_BYTES;",
        "smem_u32(smem + (s + 1) % NST * G::STAGE_BYTES), b = a + G::A_BYTES;"),
    "M42 the handoff tile's second m64 half multiplies the first half's rows of A": (
        "gemm_tn,fused_mixer_block", "csrc/gemm_sm90.cuh",
        "desc_sw128(a + h * 64 * K_BYTES + 32 * k, MN_LBO)", "desc_sw128(a + 32 * k, MN_LBO)"),
    "M43 the producer warpgroup's epilogue warps take the first warpgroup's items": (
        "gemm_tn,fused_mixer_block", "csrc/gemm_sm90.cuh",
        "epilogue(4 * HO_EPI_WGS + warp - 1);", "epilogue(warp - 1);"),
    # the handoff schedule's batched mode (an entry an image, an N-major B),
    # which the bf16 gMLP and ResMLP blocks' token products run
    "M44 the batched handoff mode loads entry 0 through the last entry's map, the last through "
    "the others'": (
        "gemm_core,fused_gmlp_block,fused_resmlp_block", "csrc/gemm_sm90.cuh",
        "const bool last = p.z == nz - 1;", "const bool last = p.z == 0;"),
    "M45 the handoff walk cuts M into whole 128-row tiles: the 68-row tail of 196 is dropped": (
        "gemm_core,fused_gmlp_block,fused_resmlp_block", "csrc/gemm_sm90.cuh",
        "const int tiles_m = (M + HO_BM - 1) / HO_BM,", "const int tiles_m = M / HO_BM,"),
    "M46 the handoff epilogue hands every tile's sums to entry 0": (
        "gemm_core,fused_gmlp_block,fused_resmlp_block", "csrc/gemm_sm90.cuh",
        "epi(p.z, gm, gn, v, min(8, N - gn));", "epi(0, gm, gn, v, min(8, N - gn));"),
    "M47 the gMLP token product reads its images' vn (N - 1)·F apart, not N·F": (
        "fused_gmlp_block", "csrc/gmlp_block.cu",
        "w.vn, F, (long long)N * F, gate", "w.vn, F, (long long)(N - 1) * F, gate"),
    # the shared GELU (x·σ(2u) on the SFU), which every bf16 and W8A8 forward
    # GELU epilogue and the Mixer backward's recomputes call
    "M48 the GELU's cubic constant is 0.04, not 0.044715": (
        "gelu,fused_gmlp_block", "csrc/common.cuh",
        "GELU_C3 = -0.1029432395800235f", "GELU_C3 = -0.0920883279257730f"),
    "M49 the GELU takes σ(-2u): the sign of 2u is flipped": (
        "gelu,fused_gmlp_block", "csrc/common.cuh",
        "const float a = x * fmaf(x * x, GELU_C3, GELU_C1);",
        "const float a = -x * fmaf(x * x, GELU_C3, GELU_C1);"),
}
TP_KERNELS = {"fused_mixer_block_tp", "mixer_block_tp_finish"}
TRAIN_KERNELS = {"fwd_with_h", "token_bwd", "chan_data_bwd", "chan_wgt_bwd"}

RUN = """
import importlib, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs
import jittor_mlp_tpu_torch as jt
names = sys.argv[1].split(",")
mods = {m: importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{m}")
        for m in cs.KERNEL_MODULES}
cs.check = lambda cond, msg: None if cond else print("  would FAIL:", msg, flush=True)
cs.phase_kernels({k: v for k, v in cs.kernel_table(mods).items() if k in names})
if set(names) & set(cs.LAB_KERNELS):
    cs.phase_lab(mods["kernel_lab"], names)
if "gemm_tn" in names:
    cs.phase_gemm(mods["gemm_sm90"])
if "gemm_core" in names:
    cs.phase_core(mods["gemm_sm90"])
    cs.phase_handoff(mods["gemm_sm90"])
    cs.phase_modes(mods["gemm_sm90"], mods["mixer_block_bwd"])
if "gelu" in names:
    cs.phase_gelu(mods["gemm_sm90"])
if "axial_shift" in names:
    cs.phase_shift(mods["axial_shift"])
if {"fused_mixer_block_tp", "mixer_block_tp_finish"} & set(names):
    cs.tp_kernels(mods, "mutation check")
if "bands" in sys.argv[2].split(","):
    cs.grad_bands(jt)
if "shift_bands" in sys.argv[2].split(","):
    cs.as_mlp_grads(jt, mods)
"""


# the kernel modules (ops/kernels) that phase 2 and the bands of each kernel
# name run, beyond the name's own module in chip_smoke's kernel table
MODULES = {"gemm_tn": ("gemm_sm90",), "gemm_core": ("gemm_sm90", "mixer_block_bwd"),
           "gelu": ("gemm_sm90",),
           "axial_shift": ("axial_shift",), "bands": ("mixer_block", "mixer_block_bwd"),
           "shift_bands": ("axial_shift",),
           **{k: ("mixer_block",) for k in TP_KERNELS}}


def _modules(names, bands, cs):
    """The kernel modules a copy's run builds, in chip_smoke's names."""
    table = {k: v[0].__name__.rsplit(".", 1)[1] for k, v in cs.kernel_table(
        {m: importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{m}")
         for m in cs.KERNEL_MODULES}).items()}
    mods = set()
    for n in list(names) + bands.split(","):
        mods.update(MODULES.get(n, ()))
        if n in table:
            mods.add(table[n])
        if n in cs.LAB_KERNELS:
            mods.add("kernel_lab")
    return mods


def _libraries(mod):
    """The kernel libraries a module of ops/kernels holds (one, or a table
    of them)."""
    from jittor_mlp_tpu_torch.ops.kernels import _build

    libs = []
    for value in vars(mod).values():
        found = value.values() if isinstance(value, dict) else [value]
        libs += [lib for lib in found if isinstance(lib, _build.Library)]
    return libs


def _prebuild(jobs, build_dir, workers):
    """Build every (copy, module) library once, several nvcc at a time, into
    the shared build directory: a library whose sources and headers a
    mutant leaves unchanged has the same name in every copy."""
    from jittor_mlp_tpu_torch.ops.kernels import _build

    todo = {}
    for dst, mod in jobs:
        csrc = os.path.join(dst, "jittor_mlp_tpu_torch", "csrc")
        for lib in _libraries(importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{mod}")):
            todo.setdefault(_build.library_path(lib.name, lib.sources, csrc, build_dir),
                            (lib.name, lib.sources, csrc))
    t0 = time.perf_counter()

    def one(args):
        name, sources, csrc = args
        try:
            _build.build(name, sources, csrc, build_dir)
            return None
        except RuntimeError as e:  # a mutant that does not compile shows in its own run
            return f"{name} in {csrc}: {str(e)[-2000:]}"

    with ThreadPoolExecutor(workers) as pool:
        errors = [e for e in pool.map(one, todo.values()) if e]
    print(f"=== built {len(todo)} libraries in {time.perf_counter() - t0:.1f} s "
          f"({workers} at a time); {len(errors)} failed", flush=True)
    for e in errors:
        print(e, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, help="comma-separated mutant tags, e.g. M10,M11")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 4,
                    help="nvcc processes at a time while the copies' libraries build")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    repo = os.getcwd()
    if not os.path.exists(os.path.join(repo, "chip_smoke.py")):
        raise SystemExit("run from the repository root")
    sys.path.insert(0, repo)
    import chip_smoke as cs

    root = os.path.join(repo, "build", "mutants")
    build_dir = os.path.join(root, "kernels")
    shutil.rmtree(root, ignore_errors=True)
    runs, jobs = [], []
    for i, (label, (kernel, path, old, new)) in enumerate(MUTANTS.items()):
        if only is not None and path and label.split()[0] not in only:
            continue
        dst = os.path.join(root, str(i))
        # the port and the smoke test are all a copy needs
        shutil.copytree(os.path.join(repo, "jittor_mlp_tpu_torch"),
                        os.path.join(dst, "jittor_mlp_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(repo, "chip_smoke.py"), dst)
        if path:
            src = os.path.join(dst, "jittor_mlp_tpu_torch", path)
            with open(src) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{label}: the line to break is not in {path} once")
            with open(src, "w") as f:
                f.write(text.replace(old, new))
        kernels = kernel or ",".join(dict.fromkeys(k for k, *_ in MUTANTS.values() if k))
        names = set(kernels.split(","))
        bands = ",".join(["-"] + ["bands"] * bool(TRAIN_KERNELS & names)
                         + ["shift_bands"] * ("axial_shift" in names))
        runs.append((label, dst, kernels, bands))
        jobs += [(dst, m) for m in sorted(_modules(names, bands, cs))]
    _prebuild(jobs, build_dir, args.jobs)
    env = dict(os.environ, JMT_KERNEL_BUILD_DIR=build_dir)
    for label, dst, kernels, bands in runs:
        print(f"=== {label} ({kernels})", flush=True)
        res = subprocess.run([sys.executable, "-c", RUN, kernels, bands], cwd=dst, env=env,
                             capture_output=True, text=True, timeout=900)
        print(res.stdout, res.stderr[-3000:], flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
