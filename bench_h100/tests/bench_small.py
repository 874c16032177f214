"""Small sizes of the benchmark's cells for the CPU tests: the cell's own
traffic kind, configuration and reference at widths a test holds."""

import time

from bench_h100 import harness

ARGS = {
    "mixer_b16": dict(in_channels=3, image_size=32, patch_size=8, d_model=32, depth=2,
                      token_dim=8, expansion_factor=4, num_classes=10),
    "resmlp_s24": dict(in_channels=3, image_size=32, patch_size=8, d_model=32, depth=2,
                       expansion_factor=4, num_classes=10),
}


def cell(name, root=harness.ROOT, **traffic):
    """The cell ``name`` at small widths and batches; ``traffic`` overrides."""
    c = harness.Cell(name, root)
    c.cfg = dict(c.cfg, args=ARGS[c.cfg["name"]])
    t = dict(c.traffic)
    t.update(batch_size=8, pool_batches=4)
    t.update(traffic)
    c.traffic = t
    return c


def run(c, seed=2**31 + 7, seconds=0.5, trace=0):
    """One CPU run of cell ``c`` through the harness, past the look for a
    card: the contract's result object."""
    import jittor_mlp_tpu_torch as program
    import jittor_mlp_tpu_torch.parallel  # noqa: F401

    r = harness.Run(c, seed, "cpu", program, t_start=time.perf_counter())
    window, numbers, peak = harness.drive(r, seconds, trace)
    return harness.result_line(r, window, numbers, peak, trace, "cpu (test)", 1)
