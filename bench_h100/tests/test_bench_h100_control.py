"""On the card, at each cell's own size: the control comes out not correct
under the cell's limits (the reference in the program's place with fp8
products; for the training cell also the fault of half of each batch left
out), and a sound run of the program comes out correct. Skips without a card:
``python -m pytest bench_h100/tests -q -m card``."""

import json
import os
import subprocess
import sys

import pytest

from bench_h100 import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


def _readings(cell, what, seed):
    out = subprocess.run([sys.executable, os.path.join(harness.ROOT, "bench_h100", "control.py"),
                          "--workload", cell, "--what", what, "--seeds", str(seed)],
                         capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.Cell(cell).limits
    for r in _readings(cell, "program", 2**31 + 101):
        assert harness.judge(r["numbers"], limits)[1], r
    for r in _readings(cell, "control", 2**31 + 102):
        assert harness.judge(r["numbers"], limits)[1] is (r["what"] == "program"), r
