"""A run that finds no card, or no program beside the benchmark, fails and
prints no result: it never falls back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

from bench_h100 import harness

ARGS = ["--workload", "mixer_b16.infer_b256", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "bench_h100/run.py", *ARGS], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    out = _run(harness.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == "", out.stdout
    assert "needs 1 CUDA card" in out.stderr


def test_without_the_program_fails_without_a_result(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, "bench_h100"), tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path), {})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
