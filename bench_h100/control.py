"""Readings for the correctness limits of a cell, on the card, at the cell's
own sizes: the program's sound runs, its control, and the faults planted
in the reference put in its place. Not part of a benchmark run.

    python3 bench_h100/control.py --workload <cell> --what program --seeds 1 2 3 ... [--seconds 2]
    python3 bench_h100/control.py --workload <cell> --what control --seeds 1 2 3 [--seconds 2]
    python3 bench_h100/control.py --workload <cell> --what int8 --seeds 1 2 3 [--seconds 2]

``program``: the cell as a run drives it, with a short window, each seed's
numbers. ``control``: the plain reference in the program's place with
every product in fp8 (e4m3, per-tensor scale; in a backward the gradients
in e5m2), the step below bf16. A classifying cell's control answers every
image of the pool in blocks of the cell's batch. A training cell's reads,
in one process, the program's run with its short window, then the
reference from the same weights and, for the tail, from the program's
state after the window: the fp8 control and the fault of half of each
batch left out (the loss's mean over the other half). ``int8``: a classifying
cell's program on its own W8A8 path (``compute="int8"``), a reading beside
the control. One JSON line a seed and kind on standard output.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    import argparse
    import json

    os.environ["JMT_KERNEL_BUILD_DIR"] = os.path.join(ROOT, "build", "kernels")
    sys.path.insert(0, ROOT)
    import torch

    import jittor_mlp_tpu_torch as program
    import jittor_mlp_tpu_torch.parallel  # noqa: F401
    from bench_h100 import harness, loads
    from bench_h100.reference import common

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("program", "control", "int8"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("control.py measures on a CUDA card")
    cell = harness.Cell(args.workload)
    kind = cell.traffic["kind"]
    if args.what == "int8" and kind == "train":
        raise SystemExit("int8 is a classifying cell's path")

    def emit(seed, what, numbers, **extra):
        print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                          "numbers": numbers, **extra}), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        traffic = dict(cell.traffic, compute="int8") if args.what == "int8" else cell.traffic
        run = harness.Run(cell, seed, args.device, program, traffic=traffic)
        if args.what != "control" or kind != "train":
            if args.what == "control":
                load = loads.KINDS[kind](run)
                load.pool = load.make_pool()
                emit(seed, "control fp8", load.control(common.matmul_fp8),
                     seconds=time.perf_counter() - t0)
            else:
                window, numbers, _ = harness.drive(run, args.seconds, False)
                emit(seed, args.what, numbers, attempted=window["attempted"],
                     failed=window["failed"], seconds=time.perf_counter() - t0)
        else:
            load = loads.Train(run)
            load.setup()
            load.window(args.seconds)
            load.finish()
            load.free()
            ref = load.reference()
            emit(seed, "program", loads.train_gaps(load.numbers, ref))
            emit(seed, "control fp8", loads.train_gaps(load.reference(mm=common.matmul_fp8), ref))
            half = load.reference(rows=slice(0, cell.traffic["batch_size"] // 2))
            emit(seed, "fault half batch", loads.train_gaps(half, ref),
                 seconds=time.perf_counter() - t0)
            del load
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
