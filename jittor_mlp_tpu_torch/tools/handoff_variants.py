"""Variants of the handoff schedule and its epilogues, timed in turns on the card.

    python -m jittor_mlp_tpu_torch.tools.handoff_variants [--only NAME ...] [--iters 20]

Run from the repository root on a machine with the card. Each variant is a
copy of the port under ``build/handoff_variants/<name>/`` (listed in
.gitignore) with lines of ``csrc/`` changed (``VARIANTS``: file, text,
replacement, as ``tools/mutation_check.py``'s mutants); the checkout itself
is not touched. The copies' libraries build first, ``--jobs`` nvcc at a
time, into one directory (a library is named by a hash of its sources, so
one a variant leaves unchanged builds once). Then each variant runs in a
process of its own, in turns (every variant, then in reverse): the bf16
gMLP-S GEMM1 + GELU (50176, 3072, 256), ResMLP-S24 FF1 + GELU (50176, 1536,
384) and the Mixer-B/16 GELU channel product (50176, 3072, 768) on the
handoff schedule (``gemm_sm90.gemm_tn``, ms), and for the variants that
change a block the bf16 gMLP-S and ResMLP-S24 blocks at b256
(``gemm_schedules.time_blocks``). The variant ``clock64`` instead counts,
a block, the cycles the handoff kernel's MMA warpgroup waits for its loads
and for the epilogue warps and the cycles those warps work, on the three
products and in the two blocks (their GELU product and token product
apart). Prints a line a variant and one JSON record; the card's name and
power limit beside them. Needs a CUDA card; the inputs are seeded.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

_GELU = '''  const float a = x * fmaf(x * x, GELU_C3, GELU_C1);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return x * r;'''
_GELU_BIAS = '''      for (int e = 0; e < 8; ++e)
        ov[e] = __float2bfloat16(
            gelu_tanh(v[e] + (per_row ? brow : __bfloat162float(bias[n + e]))));
      *reinterpret_cast<uint4*>(C + o) = out;'''
_STORE = "      *reinterpret_cast<uint4*>(C + o) = out;"
_HANDOFF_CALL = "          epi(p.z, gm, gn, v, min(8, N - gn));"
_SUMS_STORE = '''            *reinterpret_cast<float2*>(sums + (64 * h + 16 * warp + r + 8 * i) * HO_LD + 8 * j +
                                       2 * q) ='''
H, B16, COMMON = "csrc/gemm_sm90.cuh", "csrc/gemm_bf16.cuh", "csrc/common.cuh"
GMLP, RES = "csrc/gmlp_block.cu", "csrc/resmlp_block.cu"

# the handoff kernel's clock64 counts: a __device__ array of 32 counters (16
# a TB), read and cleared by handoff_prof, which this variant adds
_CLOCK64 = [
    (H, "#include <algorithm>\n#include <atomic>\n",
     "#include <algorithm>\n#include <atomic>\n"
     "__device__ unsigned long long g_prof[32];\n"
     "extern \"C\" int handoff_prof(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
     "  unsigned long long z[32] = {};\n"
     "  cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
     "  return (int)e;\n}\n"),
    (H, "  auto epilogue = [&](int e) {\n    constexpr int RUNS",
     "  auto epilogue = [&](int e) {\n    unsigned long long Ew = 0, Ep = 0;\n    constexpr int RUNS"),
    (H, "      mbar_wait(sums_full, t & 1);\n      for (int item = e;",
     "      const long long c0 = clock64();\n      mbar_wait(sums_full, t & 1);\n"
     "      const long long c1 = clock64();\n      Ew += c1 - c0;\n      for (int item = e;"),
    (H, "      __syncwarp();\n      if (lane == 0) mbar_arrive(sums_empty);\n    }\n  };",
     "      __syncwarp();\n      if (lane == 0) mbar_arrive(sums_empty);\n      Ep += clock64() - c1;\n"
     "    }\n    if (lane == 0 && e == 0) {\n      atomicAdd(&g_prof[16 * TB + 4], Ew);\n"
     "      atomicAdd(&g_prof[16 * TB + 5], Ep);\n    }\n  };"),
    (H, "    float acc[2][HO_BN / 2];  // the tile's two m64 halves\n    int it = 0;",
     "    float acc[2][HO_BN / 2];  // the tile's two m64 halves\n    int it = 0;\n"
     "    const long long T0 = clock64();\n    long long Tf = 0, Ts = 0;"),
    (H, "        mbar_wait(&full[s], (it / NST) & 1);\n        const uint32_t a = smem_u32(smem + s * G::STAGE_BYTES), b = a + G::A_BYTES;",
     "        const long long cf = clock64();\n        mbar_wait(&full[s], (it / NST) & 1);\n"
     "        Tf += clock64() - cf;\n"
     "        const uint32_t a = smem_u32(smem + s * G::STAGE_BYTES), b = a + G::A_BYTES;"),
    (H, "      mbar_wait(sums_empty, (t & 1) ^ 1);  // the previous tile's sums are read",
     "      const long long cs = clock64();\n"
     "      mbar_wait(sums_empty, (t & 1) ^ 1);  // the previous tile's sums are read\n"
     "      Ts += clock64() - cs;"),
    (H, "      __syncwarp();\n      if (lane == 0) mbar_arrive(sums_full);\n    }\n  } else {",
     "      __syncwarp();\n      if (lane == 0) mbar_arrive(sums_full);\n    }\n"
     "    if (threadIdx.x == 128) {\n"
     "      atomicAdd(&g_prof[16 * TB], (unsigned long long)(clock64() - T0));\n"
     "      atomicAdd(&g_prof[16 * TB + 1], (unsigned long long)Tf);\n"
     "      atomicAdd(&g_prof[16 * TB + 2], (unsigned long long)Ts);\n    }\n  } else {"),
]
COUNTERS = {0: "total", 1: "MMA waits on loads", 2: "MMA waits on the epilogue",
            4: "epilogue warp waits", 5: "epilogue warp works"}

# name -> (the edits, whether it changes a block's code beyond the core's)
VARIANTS = {
    "as built": ([], True),
    "libm tanhf GELU": ([(COMMON, _GELU, "  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * "
                                          "(x + 0.044715f * x * x * x)));")], True),
    "identity GELU": ([(COMMON, _GELU, "  return x;")], False),
    "no functor call": ([(H, _HANDOFF_CALL, '          asm volatile("" ::"f"(v[0]), "f"(v[7]));')],
                        False),
    "no bias loads": ([(B16, _GELU_BIAS, "      for (int e = 0; e < 8; ++e)\n"
                                         "        ov[e] = __float2bfloat16(gelu_tanh(v[e]));\n"
                        + _STORE)], False),
    "no stores": ([(B16, _GELU_BIAS, _GELU_BIAS.replace(
        _STORE, "      if (out.x == 0x7fc17fc1u && out.y == 0x7fc27fc2u) " + _STORE.strip()))],
                  False),
    "bias in one 16-byte load": ([(B16, _GELU_BIAS,
                                   "      const uint4 bv = *reinterpret_cast<const uint4*>("
                                   "bias + (per_row ? 0 : n));\n"
                                   "      for (int e = 0; e < 8; ++e)\n"
                                   "        ov[e] = __float2bfloat16(gelu_tanh(v[e] + "
                                   "(per_row ? brow : at8(bv, e))));\n" + _STORE)], False),
    "Newton reciprocal": ([(COMMON, '  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));',
                            "  const float s = 1.0f + e;\n"
                            "  r = __int_as_float(0x7EF311C3 - __float_as_int(s));\n"
                            "  r = r * fmaf(-s, r, 2.0f);\n  r = r * fmaf(-s, r, 2.0f);\n"
                            "  r = r * fmaf(-s, r, 2.0f);")], False),
    "swizzled sums": ([
        (H, "constexpr int HO_LD = HO_BN + 8;", "constexpr int HO_LD = HO_BN;"),
        (H, "// Output tile `tile` of the handoff schedule's walk",
         "__device__ __forceinline__ int sums_at(int row, int col) {\n"
         "  return row * HO_LD + (col ^ ((((row & 3) << 1) | (row & 1)) << 2));\n}\n\n"
         "// Output tile `tile` of the handoff schedule's walk"),
        (H, "          load8(sums + row * HO_LD + col, v);",
         "          const float4 lo = *reinterpret_cast<const float4*>(sums + sums_at(row, col));\n"
         "          const float4 hi = *reinterpret_cast<const float4*>(sums + sums_at(row, col + 4));\n"
         "          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;\n"
         "          v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;"),
        (H, _SUMS_STORE, "            *reinterpret_cast<float2*>(sums + sums_at(64 * h + 16 * warp + "
                         "r + 8 * i, 8 * j + 2 * q)) =")], False),
    "gate without u": ([(GMLP, "const uint4 uu = *reinterpret_cast<const uint4*>(u);",
                         "const uint4 uu = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, "
                         "0x3f803f80u);")], True),
    "token products cooperative": ([(f, "gemm_bf16<false, true, sm90::Sched::Handoff>",
                                     "gemm_bf16<false, true>") for f in (GMLP, RES)], True),
    "GELU products cooperative": ([(f, "gemm_tn<sm90::Sched::Handoff>", "gemm_tn")
                                   for f in (GMLP, RES)], True),
    "clock64": (_CLOCK64, True),
}

# one variant's timings, in a process of its own (the variant's root first
# on the path): the three GELU products on the handoff schedule, and the
# blocks where the variant changes them
_TIME = """
import json, sys, torch
from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90 as g
from jittor_mlp_tpu_torch.tools import gemm_schedules as gs
iters, blocks = int(sys.argv[1]), sys.argv[2] == "1"
rec = {}
for tag, (M, N, K) in (("gMLP-S GEMM1 + GELU", (50176, 3072, 256)),
                       ("ResMLP-S24 FF1 + GELU", (50176, 1536, 384)),
                       ("Mixer-B/16 GELU product", (50176, 3072, 768))):
    a, b, bias, kw = gs.inputs(M, N, K, False)
    rec[tag] = gs.cuda_ms(lambda: g.gemm_tn(a, b, bias, core="handoff", **kw), iters)
    del a, b, bias, kw
if blocks:
    rec.update(gs.time_blocks(iters))
print("RECORD", json.dumps(rec), flush=True)
"""

# the clock64 variant's counts a block and launch
_COUNT = """
import ctypes, json, torch
from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90 as g, gmlp_block as gb, resmlp_block as rb
from jittor_mlp_tpu_torch.tools import gemm_schedules as gs
NAMES = %r
def read(lib):
    buf = (ctypes.c_ulonglong * 32)()
    lib.load().handoff_prof(buf)
    return list(buf)
out = {}
def count(tag, lib, fn, n=5):
    fn(); torch.cuda.synchronize(); read(lib)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    v = read(lib)
    for tb, what in ((0, "GELU product"), (1, "token product")):
        if v[16 * tb]:
            out[f"{tag}, {what}"] = {k: v[16 * tb + int(i)] / (132 * n) for i, k in NAMES.items()}
for tag, (M, N, K) in (("gMLP-S GEMM1 + GELU", (50176, 3072, 256)),
                       ("Mixer-B/16 GELU product", (50176, 3072, 768))):
    a, b, bias, kw = gs.inputs(M, N, K, False)
    count(tag, g._LIB, lambda: g.gemm_tn(a, b, bias, core="handoff", **kw))
    del a, b, bias, kw
blocks = gs.block_inputs()
for k, lib in (("bf16 gMLP-S block", gb._LIB), ("bf16 ResMLP-S24 block", rb._LIB)):
    f, x, w = blocks[k]
    count(k, lib, lambda: f(x, *w))
print("RECORD", json.dumps(out), flush=True)
"""


def make(root, name, edits):
    """A copy of the port and pyproject.toml under root/<name> with the
    edits applied (each text must occur in its file)."""
    dst = os.path.join(root, name.replace(" ", "_"))
    shutil.copytree("jittor_mlp_tpu_torch", os.path.join(dst, "jittor_mlp_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy("pyproject.toml", dst)
    for path, old, new in edits:
        p = os.path.join(dst, "jittor_mlp_tpu_torch", path)
        with open(p) as f:
            text = f.read()
        if old not in text:
            raise SystemExit(f"{name}: the text to change is not in {path}")
        with open(p, "w") as f:
            f.write(text.replace(old, new))
    return dst


def run(dst, env, code, *args):
    """The RECORD a child process prints, or its error. It runs in the
    variant's root, so that its copy of the port is the one imported."""
    res = subprocess.run([sys.executable, "-c", code, *args], cwd=dst, env=env,
                         capture_output=True, text=True, timeout=900)
    line = [l for l in res.stdout.splitlines() if l.startswith("RECORD ")]
    return json.loads(line[-1][7:]) if line else {"error": res.stderr[-2000:]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", default=None, help="variant names (by default all)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 4)
    args = ap.parse_args()
    if not os.path.exists("chip_smoke.py"):
        raise SystemExit("run from the repository root")
    from jittor_mlp_tpu_torch.tools.gemm_schedules import card

    names = args.only or list(VARIANTS)
    root = os.path.join("build", "handoff_variants")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {n: make(root, n, VARIANTS[n][0]) for n in names}
    env = dict(os.environ, JMT_KERNEL_BUILD_DIR=os.path.abspath(os.path.join(root, "kernels")))
    jobs = [(n, m) for n in names for m in ("gemm_sm90",) + (
        ("gmlp_block", "resmlp_block", "mixer_block") if VARIANTS[n][1] else ())]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        errors = [e for e in pool.map(lambda j: run(
            dirs[j[0]], env, f"from jittor_mlp_tpu_torch.ops.kernels import {j[1]} as m\n"
            f"m.build()\nprint('RECORD {{}}')").get("error"), jobs) if e]
    print(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s; "
          f"{len(errors)} failed", flush=True)
    for e in errors:
        print(e, flush=True)
    name = card()
    record = {"card": name}
    timed = [n for n in names if n != "clock64"]
    for n in timed + timed[::-1]:
        rec = run(dirs[n], env, _TIME, str(args.iters), str(int(VARIANTS[n][1])))
        record.setdefault(n, []).append(rec)
        print(f"{n}: " + "; ".join(f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in rec.items()) + f"  [{name}]", flush=True)
    if "clock64" in names:
        rec = run(dirs["clock64"], env, _COUNT % {str(k): v for k, v in COUNTERS.items()})
        record["clock64"] = rec
        for tag, c in rec.items():
            if tag == "error":
                print(f"clock64: {c}", flush=True)
                continue
            print(f"clock64 {tag}: " + "; ".join(
                f"{k} {v:.0f} cycles ({100 * v / c['total']:.1f}%)" for k, v in c.items())
                + f"  [{name}]", flush=True)
    print(json.dumps(record), flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
