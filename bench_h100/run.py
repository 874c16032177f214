"""One run of one cell of the port's benchmark, from the root of a checkout:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and ``check``: each number compared with its limit); the
last lines of standard error repeat the check. Without a CUDA card, without
the program beside this folder, or with ``jax``, ``jaxlib``, ``flax`` or
``jittor_mlp_tpu`` loaded after the window, it exits with a code other than
0 and prints no result.

The program's kernel builds and any Triton cache go to fixed directories
under ``build/`` in the checkout, so only a cell's first run there builds.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    os.environ["JMT_KERNEL_BUILD_DIR"] = os.path.join(ROOT, "build", "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)
    from bench_h100 import harness

    return harness.main(sys.argv[1:] if argv is None else argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
