"""The GEMM core's products and the blocks that run them on each schedule, timed in turns.

    python -m jittor_mlp_tpu_torch.tools.gemm_schedules [--shapes M,N,K ...] [--blocks] [--iters 20]

``ops/kernels/gemm_sm90.gemm_tn`` runs one K-major bf16 product on the
wgmma core's cooperative schedule (``core="sm90"``: three consumer
warpgroups on one 192×192 tile, then all three in the epilogue) or its
handoff schedule (``core="handoff"``: one warpgroup's K loops back to back,
each tile's sums handed through shared memory to epilogue warps that run
under the next tile's wgmmas), and cuBLAS's ``torch.matmul`` computes the
product alone, without an epilogue. For each shape (by default Mixer-B/16's
two channel products at b256) and each of gemm_tn's epilogues (the tanh
GELU, and the residual add), it times the three in turns (each, then in
reverse; the mean of the two runs of ``iters`` calls) and prints ms and
TFLOP/s beside the card's name and power limit. The same K loop under both
epilogues splits a product's time into its K loop and its epilogue.

``--blocks`` adds, at b256: kernel 1 (Mixer-B/16), the bf16 gMLP-S block
and the bf16 ResMLP-S24 block, in turns; their GELU channel products
(gMLP-S's GEMM1, ResMLP-S24's FF1) and last ones (GEMM2, FF2, with the
residual epilogue) on each schedule; and their token products (an entry an
image, the weight a shared A in rows of 200, the activations an N-major B;
f32 out through ``gemm_bf16``) on each schedule this build has (the batched
handoff mode, ``gemm_bf16(core="handoff")``, may be absent from an older
checkout: run this file with another checkout first on ``PYTHONPATH`` to
time that one's build). Needs a CUDA card; the inputs are seeded.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90, gmlp_block, mixer_block, resmlp_block

SHAPES = ((256 * 196, 3072, 768), (256 * 196, 768, 3072))  # Mixer-B/16's pair at b256
PEAK_BF16 = 989e12  # dense bf16 FLOP/s of an H100 SXM at 700 W
B, N = 256, 196  # the blocks' batch and tokens
# gMLP-S's and ResMLP-S24's channel products at b256, as (tag, (M, N, K),
# residual epilogue)
BLOCK_CHANNEL = [("gMLP-S GEMM1", (B * N, 3072, 256), False),
                 ("gMLP-S GEMM2", (B * N, 256, 1536), True),
                 ("ResMLP-S24 FF1", (B * N, 1536, 384), False),
                 ("ResMLP-S24 FF2", (B * N, 384, 1536), True)]
# their token products: (tag, columns a token row of an image)
BLOCK_TOKEN = [("gMLP-S token product", 1536), ("ResMLP-S24 token product", 384)]


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean ms of ``fn`` over ``iters`` calls between CUDA events, after a
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def turns(ways, iters):
    """{way: mean ms}: each way, then in reverse."""
    runs = {k: [] for k in ways}
    for k in list(ways) + list(ways)[::-1]:
        runs[k].append(cuda_ms(ways[k], iters))
    return {k: sum(r) / len(r) for k, r in runs.items()}


def _gen(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0, mean=0.0):
        return (mean + torch.randn(shape, generator=g, device="cuda") * scale).bfloat16()

    def lin(out, fan_in):  # a weight (out, fan_in) and its bias, as a block's
        return rn(out, fan_in, scale=fan_in ** -0.5), rn(out, scale=0.5)

    return rn, lin


def inputs(M, N, K, residual, seed=0):
    """a (M, K), b (N, K), bias (N,) bf16 on the card, scaled like a
    block's channel product, and the epilogue's keyword."""
    rn, _ = _gen(seed)
    kw = {"residual": rn(M, N)} if residual else {"act": "gelu_tanh"}
    return rn(M, K), rn(N, K, scale=K ** -0.5), rn(N, scale=0.1), kw


def time_shape(M, N, K, iters):
    """{epilogue: {way: ms}} of one shape, the ways timed in turns."""
    out = {}
    for residual in (False, True):
        a, b, bias, kw = inputs(M, N, K, residual)
        ways = {"cooperative": lambda: gemm_sm90.gemm_tn(a, b, bias, core="sm90", **kw),
                "handoff": lambda: gemm_sm90.gemm_tn(a, b, bias, core="handoff", **kw),
                "cuBLAS (no epilogue)": lambda: torch.matmul(a, b.t())}
        out["residual" if residual else "gelu_tanh"] = turns(ways, iters)
        del a, b, bias, kw
        torch.cuda.empty_cache()
    return out


def block_inputs(seed=7):
    """{block: (wrapper, x, weights)} at b256: Mixer-B/16, gMLP-S and
    ResMLP-S24, weights 1/sqrt(fan_in), biases std 0.5, norms and affines
    near 1."""
    rn, lin = _gen(seed)

    def near1(n):
        return rn(n, scale=0.1, mean=1.0), rn(n, scale=0.1)

    mixer = (rn(B, N, 768), (*near1(768), *lin(384, N), *lin(N, 384), *near1(768),
                             *lin(3072, 768), *lin(768, 3072)))
    gmlp = (rn(B, N, 256), (*near1(256), *lin(3072, 256), *near1(1536), lin(N, N)[0],
                            rn(N, scale=0.5, mean=1.0), *lin(256, 1536)))
    wt, bt = lin(N, N)
    res = (rn(B, N, 384), (*near1(384), rn(384, scale=0.1, mean=1.0), wt, bt, *near1(384),
                           rn(384, scale=0.1, mean=1.0), *lin(1536, 384), *lin(384, 1536)))
    return {"kernel 1 (Mixer-B/16)": (mixer_block.fused_mixer_block, *mixer),
            "bf16 gMLP-S block": (gmlp_block.fused_gmlp_block, *gmlp),
            "bf16 ResMLP-S24 block": (resmlp_block.fused_resmlp_block, *res)}


def time_blocks(iters):
    """{block: ms} of the three blocks at b256, in turns."""
    blocks = block_inputs()
    ms = turns({k: (lambda f=f, x=x, w=w: f(x, *w)) for k, (f, x, w) in blocks.items()}, iters)
    del blocks
    torch.cuda.empty_cache()
    return ms


def time_block_products(iters):
    """{product: (flop, {way: ms})}: the gMLP-S and ResMLP-S24 blocks'
    products at b256 on each schedule this build has, and cuBLAS's."""
    out = {}
    for tag, (M, Nc, K), residual in BLOCK_CHANNEL:
        a, b, bias, kw = inputs(M, Nc, K, residual)
        out[f"{tag} {(M, Nc, K)} {'residual' if residual else 'gelu_tanh'}"] = (
            2 * M * Nc * K, turns(
                {"cooperative": lambda: gemm_sm90.gemm_tn(a, b, bias, core="sm90", **kw),
                 "handoff": lambda: gemm_sm90.gemm_tn(a, b, bias, core="handoff", **kw),
                 "cuBLAS (no epilogue)": lambda: torch.matmul(a, b.t())}, iters))
        del a, b, bias, kw
    rn, _ = _gen(8)
    for tag, cols in BLOCK_TOKEN:
        wsp = rn(N, 200, scale=N ** -0.5)[:, :N]  # a block's copy: rows of round_up(N, 8)
        v = rn(B, N, cols)
        ways = {"cooperative": lambda: gemm_sm90.gemm_bf16(wsp, v, b_mn=True, core="sm90"),
                "handoff": lambda: gemm_sm90.gemm_bf16(wsp, v, b_mn=True, core="handoff"),
                "torch.matmul": lambda: torch.matmul(wsp, v)}
        try:
            ways["handoff"]()
        except ValueError:  # a build without the batched handoff mode
            del ways["handoff"]
        out[f"{tag} {B} x (M, N, K) {(N, cols, N)} f32 out"] = (2 * B * N * cols * N,
                                                                 turns(ways, iters))
        del wsp, v
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=[",".join(map(str, s)) for s in SHAPES],
                    help="M,N,K of each product")
    ap.add_argument("--blocks", action="store_true",
                    help="also the bf16 Mixer, gMLP and ResMLP blocks and their products")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_schedules needs a CUDA card")
    name = card()
    print(f"card: {name}; the core: {gemm_sm90.config()}", flush=True)
    record = {"card": name}
    for shape in args.shapes:
        M, N_, K = (int(v) for v in shape.split(","))
        flop = 2 * M * N_ * K
        for epi, ms in time_shape(M, N_, K, args.iters).items():
            record[f"({M}, {N_}, {K}) {epi}"] = ms
            rates = {k: flop / v / 1e9 for k, v in ms.items()}  # TFLOP/s
            print(f"({M}, {N_}, {K}) {epi}: " + "; ".join(
                f"{k} {ms[k]:.4f} ms, {rates[k]:.1f} TFLOP/s ({rates[k] * 1e14 / PEAK_BF16:.1f}%)"
                for k in ms) + f"  [{name}]", flush=True)
    if args.blocks:
        for blk, ms in time_blocks(args.iters).items():
            record[blk] = ms
            print(f"{blk} b256: {ms:.4f} ms  [{name}]", flush=True)
        for tag, (flop, ms) in time_block_products(args.iters).items():
            record[tag] = ms
            print(f"{tag}: " + "; ".join(f"{k} {v:.4f} ms, {flop / v / 1e9:.1f} TFLOP/s"
                                         for k, v in ms.items()) + f"  [{name}]", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
