"""The GEMM core's channel products on each schedule, timed in turns on the card.

    python -m jittor_mlp_tpu_torch.tools.gemm_schedules [--shapes M,N,K ...] [--iters 20]

``ops/kernels/gemm_sm90.gemm_tn`` runs one K-major bf16 product on the
wgmma core's cooperative schedule (``core="sm90"``: three consumer
warpgroups on one 192×192 tile, then all three in the epilogue) or its
handoff schedule (``core="handoff"``: one warpgroup's K loops back to back,
each tile's sums handed through shared memory to epilogue warps that run
under the next tile's wgmmas), and cuBLAS's
``torch.matmul`` computes the product alone, without an epilogue. For each
shape (by default Mixer-B/16's two channel products at b256) and each of
gemm_tn's epilogues (the tanh GELU, and the residual add), it times the
three in turns (each, then in reverse; the mean of the two runs of
``iters`` calls) and prints ms and TFLOP/s beside the card's name and power
limit. The same K loop under both epilogues splits a product's time into
its K loop and its epilogue. Needs a CUDA card; the inputs are seeded.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90

SHAPES = ((256 * 196, 3072, 768), (256 * 196, 768, 3072))  # Mixer-B/16's pair at b256
PEAK_BF16 = 989e12  # dense bf16 FLOP/s of an H100 SXM at 700 W


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


def inputs(M, N, K, residual, seed=0):
    """a (M, K), b (N, K), bias (N,) bf16 on the card, scaled like a
    block's channel product, and the epilogue's keyword."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).bfloat16()

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
        runs = {k: [] for k in ways}
        for k in list(ways) + list(ways)[::-1]:
            runs[k].append(cuda_ms(ways[k], iters))
        out["residual" if residual else "gelu_tanh"] = {k: sum(r) / len(r) for k, r in runs.items()}
        del a, b, bias, kw
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=[",".join(map(str, s)) for s in SHAPES],
                    help="M,N,K of each product")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_schedules needs a CUDA card")
    name = card()
    print(f"card: {name}; the core: {gemm_sm90.config()}", flush=True)
    for shape in args.shapes:
        M, N, K = (int(v) for v in shape.split(","))
        flop = 2 * M * N * K
        for epi, ms in time_shape(M, N, K, args.iters).items():
            rates = {k: flop / v / 1e9 for k, v in ms.items()}  # TFLOP/s
            print(f"({M}, {N}, {K}) {epi}: " + "; ".join(
                f"{k} {ms[k]:.4f} ms, {rates[k]:.1f} TFLOP/s ({rates[k] * 1e14 / PEAK_BF16:.1f}%)"
                for k in ms) + f"  [{name}]", flush=True)


if __name__ == "__main__":
    main()
