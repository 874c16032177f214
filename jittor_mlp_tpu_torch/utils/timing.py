"""Throughput of a forward on a device-resident batch (counterpart of
``jittor_mlp_tpu/utils/timing.py``).

On the card the clock is CUDA events around a run of ``iters`` calls on
one input made on the device: a warm-up call, then the best of ``repeats``
runs. ``time.perf_counter`` times a CPU device, where calls are
synchronous. No batch crosses the host link inside the timed region.
"""

from __future__ import annotations

import time

import torch


def throughput(fn, batch_shape, iters=20, dtype=torch.bfloat16, repeats=3, device="cuda"):
    """Images per second of ``fn(x)`` for a normal input of ``batch_shape``
    (NCHW) and ``dtype``, drawn on ``device`` from a generator seeded with
    0: ``batch_shape[0] · iters`` over the best of ``repeats`` timed runs of
    ``iters`` calls, after one warm-up call."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(batch_shape, generator=g, device=device).to(dtype)
    with torch.inference_mode():
        fn(x)
        best = float("inf")
        for _ in range(repeats):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(device)
                start.record()
                for _ in range(iters):
                    fn(x)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                dt = time.perf_counter() - t0
            best = min(best, dt)
    return batch_shape[0] * iters / best
