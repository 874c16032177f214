"""The port's harness (jittor_mlp_tpu_torch/tools/compare.py) on the CPU, with
small configs passed in: its records carry what the generator reads, its
statistics are the JAX harness's formulas, its train measurement picks the
faster route and lets real errors through, and --all writes one record per
model."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.tools import compare, gen_tuned

SMALL = {
    "mlp_mixer": ("mlp_mixer", "MLPMixerForImageClassification",
                  "MLPMixerForImageClassification",
                  dict(image_size=32, patch_size=8, d_model=16, depth=1, num_classes=10)),
    "conv_mixer": ("conv_mixer", "ConvMixer", "ConvMixer",
                   dict(dim=16, depth=2, kernel_size=3, patch_size=8, n_classes=10)),
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--device", "cpu", "--batch", "2", "--iters", "2", "--image-size", "32"]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(compare, "CONFIGS", SMALL)
    monkeypatch.setattr(gen_tuned, "CONFIGS", SMALL)


def test_configs_match_the_jax_harness():
    import jittor_mlp_tpu as jm

    spec = importlib.util.spec_from_file_location("jax_compare", os.path.join(ROOT, "compare.py"))
    jax_compare = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_compare)
    assert compare.CONFIGS == jax_compare.CONFIGS
    for name in compare.CONFIGS:
        _, ref_cls, our_name, _ = compare.CONFIGS[name]
        assert compare.factory_of(name).__name__ == (our_name or ref_cls)
        if our_name:
            assert hasattr(jm, our_name)


def test_record_has_what_the_generator_reads(small, tmp_path):
    out = tmp_path / "rec.jsonl"
    rc = compare.main(["--model", "mlp_mixer", *FLAGS, "--int8", "--serving-numerics",
                       "--train", "--try-remat", "--json", str(out)])
    assert rc == 0
    (rec,) = gen_tuned.read_jsonl(out)
    floats = ("fps", "int8_fps", "bf16_max_rel", "bf16_mean_rel", "bf16_argmax_agree",
              "int8_max_rel", "int8_mean_rel", "int8_argmax_agree", "int8_argmax_agree_vs_bf16",
              "train_fps", "max_abs", "mean_abs", "max_rel", "out_scale")
    for k in floats:
        assert isinstance(rec[k], float) and np.isfinite(rec[k]), k
    assert rec["model"] == "mlp_mixer" and rec["batch"] == 2 and rec["train_batch"] == 2
    assert isinstance(rec["train_remat"], bool) and rec["parity_ok"] is True
    assert rec["numerics_batch"] == 64 and rec["params"] > 0
    assert (rec["device"], rec["card"], rec["power_limit"]) == ("cpu", "cpu", None)
    # the CPU against itself
    assert rec["max_abs"] == 0.0
    assert gen_tuned.serve_row(rec)["dtype"] in ("bf16", "int8", "f32")
    assert gen_tuned.train_rows([rec])["mlp_mixer"]["batch"] == 2


def test_serving_stats_match_numpy():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((16, 10)).astype(np.float32) * 4
    b = f + rng.standard_normal((16, 10)).astype(np.float32) * 0.3
    q = f + rng.standard_normal((16, 10)).astype(np.float32) * 0.9
    got = compare.serving_stats(*(torch.from_numpy(a) for a in (f, b, q)))
    scale = np.abs(f).max()
    want = {
        "bf16_max_rel": np.abs(b - f).max() / scale,
        "bf16_mean_rel": np.abs(b - f).mean() / scale,
        "bf16_argmax_agree": np.mean(b.argmax(-1) == f.argmax(-1)),
        "int8_max_rel": np.abs(q - f).max() / scale,
        "int8_mean_rel": np.abs(q - f).mean() / scale,
        "int8_argmax_agree": np.mean(q.argmax(-1) == f.argmax(-1)),
        "int8_argmax_agree_vs_bf16": np.mean(q.argmax(-1) == b.argmax(-1)),
    }
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert 0 < got["int8_argmax_agree"] < 1  # the arrays exercise disagreement


def test_serving_numerics_read_the_three_precisions(small):
    rec = compare.run_serving_numerics("conv_mixer", batch=4, image_size=32, device="cpu")
    assert rec["numerics_batch"] == 4
    assert 0 < rec["bf16_max_rel"] < 0.1 and rec["bf16_argmax_agree"] > 0


@pytest.mark.parametrize("plain,remat", [(5.0, 10.0), (10.0, 5.0)], ids=["remat-faster",
                                                                          "plain-faster"])
def test_try_remat_reports_the_faster_run(monkeypatch, plain, remat):
    monkeypatch.setattr(compare, "_train_img_s",
                        lambda *a: remat if config.remat else plain)
    got = compare.run_train_throughput("mlp_mixer", try_remat=True, device="cpu")
    assert got == (max(plain, remat), remat > plain)
    assert compare.run_train_throughput("mlp_mixer", device="cpu") == (plain, False)


def test_out_of_memory_retries_under_remat(monkeypatch):
    def step(*a):
        if not config.remat:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 7.0

    monkeypatch.setattr(compare, "_train_img_s", step)
    assert compare.run_train_throughput("mlp_mixer", device="cpu") == (7.0, True)


def test_other_train_errors_propagate(monkeypatch):
    calls = []

    def step(*a):
        calls.append(config.remat)
        raise ValueError("a real bug")

    monkeypatch.setattr(compare, "_train_img_s", step)
    with pytest.raises(ValueError, match="a real bug"):
        compare.run_train_throughput("mlp_mixer", try_remat=True, device="cpu")
    assert calls == [False]  # no relabelled retry under remat


def test_train_throughput_runs_steps(small):
    img_s, remat = compare.run_train_throughput("mlp_mixer", batch=2, iters=2, image_size=32,
                                                device="cpu")
    assert img_s > 0 and remat is False


def test_all_appends_one_record_per_model_and_fails_on_a_train_error(small, monkeypatch,
                                                                     tmp_path):
    out = tmp_path / "sweep.jsonl"
    out.write_text('{"model": "stale"}\n')  # --all starts the file anew
    children = []

    def child(name, base):  # the model's process, run here
        children.append((name, base))
        return compare.main(["--model", name, *base])

    real = compare._train_img_s

    def step(name, *a):
        if name == "conv_mixer":
            raise RuntimeError("no kernel image\nsecond line")
        return real(name, *a)

    monkeypatch.setattr(compare, "_child", child)
    monkeypatch.setattr(compare, "_train_img_s", step)
    argv = ["--all", "--model", "vip", *FLAGS, "--skip-parity", "--skip-throughput", "--train",
            "--json", str(out)]
    assert compare.main(argv) == 1
    assert [n for n, _ in children] == sorted(SMALL)
    assert all("--all" not in b and "vip" not in b for _, b in children)
    recs = gen_tuned.read_jsonl(out)
    assert [r["model"] for r in recs] == sorted(SMALL)
    by = {r["model"]: r for r in recs}
    assert by["conv_mixer"]["train_error"] == "RuntimeError: no kernel image"
    assert by["mlp_mixer"]["train_fps"] > 0 and "train_error" not in by["mlp_mixer"]
    assert list(gen_tuned.train_rows(recs)) == ["mlp_mixer"]
    # without the failing model the sweep exits 0
    monkeypatch.setattr(compare, "CONFIGS", {"mlp_mixer": SMALL["mlp_mixer"]})
    assert compare.main(argv) == 0


def test_all_runs_each_model_in_a_process_of_its_own(small, monkeypatch):
    cmds = []

    def run(cmd, *a, **k):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 3 if "conv_mixer" in cmd else 0)

    monkeypatch.setattr(compare.subprocess, "run", run)
    assert compare.main(["--all", "--device", "cpu", "--train"]) == 3
    assert cmds == [[sys.executable, "-m", "jittor_mlp_tpu_torch.tools.compare", "--model", name,
                     "--device", "cpu", "--train"] for name in sorted(SMALL)]


def test_parity_recalibrates_batch_norm(small):
    rec = compare.run_parity("conv_mixer", image_size=32, device="cpu")
    assert rec["bn_recalibrated"] is True and rec["parity_ok"] is True
    assert rec["params"] == compare.build_ours("conv_mixer", "cpu").param_count()
    assert compare.run_parity("mlp_mixer", image_size=32, device="cpu")["bn_recalibrated"] is False


def test_list_and_cuda_without_a_card(capsys):
    assert compare.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(compare.CONFIGS)
    if not torch.cuda.is_available():  # no CPU fallback
        with pytest.raises(RuntimeError):
            compare.run_throughput("mlp_mixer", batch=1, iters=1)
