"""The port's tuned-table generator (jittor_mlp_tpu_torch/tools/gen_tuned.py)
against the JAX package's rule and table, and the committed table against
the committed sweeps.

The JAX rows come from the repository's own sweeps (serving_sweep.jsonl,
train_sweep.jsonl), read only, as rule input: fed the same records, the
port's generator must make the choices jittor_mlp_tpu/tuned.py holds.
"""

import importlib.util
import os

import pytest

from jittor_mlp_tpu import tuned as jax_tuned
from jittor_mlp_tpu_torch import tuned
from jittor_mlp_tpu_torch.tools import gen_tuned
from jittor_mlp_tpu_torch.tools.compare import CONFIGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = sorted(CONFIGS)


@pytest.fixture(scope="module")
def jax_rows():
    train = gen_tuned.train_rows(gen_tuned.read_jsonl(os.path.join(ROOT, "train_sweep.jsonl")))
    serve = gen_tuned.serve_rows(gen_tuned.read_jsonl(os.path.join(ROOT, "serving_sweep.jsonl")))
    return train, serve


def test_configs_are_the_jax_harness_keys():
    assert set(KEYS) == set(jax_tuned.SERVE) == set(jax_tuned.TRAIN)
    assert len(KEYS) == 23


@pytest.mark.parametrize("key", KEYS)
def test_serve_row_matches_jax(jax_rows, key):
    want = jax_tuned.SERVE[key]
    got = jax_rows[1][key]
    assert (got["dtype"], got["factory"]) == (want["dtype"], want["factory"])


@pytest.mark.parametrize("key", KEYS)
def test_train_row_matches_jax(jax_rows, key):
    want = jax_tuned.TRAIN[key]
    got = jax_rows[0][key]
    assert (got["remat"], got["batch"], got["factory"]) == (
        want["remat"], want["batch"], want["factory"])


def _serving(bf16_agree=1.0, fps=1000.0, int8_fps=500.0, int8_vs_bf16=1.0):
    return {"model": "mlp_mixer", "fps": fps, "int8_fps": int8_fps,
            "bf16_argmax_agree": bf16_agree, "int8_argmax_agree": int8_vs_bf16,
            "int8_argmax_agree_vs_bf16": int8_vs_bf16}


@pytest.mark.parametrize("record,dtype", [
    (_serving(bf16_agree=0.8999), "f32"),
    (_serving(bf16_agree=0.9), "bf16"),
    # f32 wins over a faster int8
    (_serving(bf16_agree=0.8999, int8_fps=2000.0), "f32"),
    (_serving(int8_fps=1050.0, int8_vs_bf16=0.98), "int8"),
    (_serving(int8_fps=1049.0, int8_vs_bf16=1.0), "bf16"),
    (_serving(int8_fps=2000.0, int8_vs_bf16=0.9799), "bf16"),
], ids=["agree-0.8999-f32", "agree-0.90-bf16", "f32-before-int8", "int8-at-1.05x-0.98",
        "int8-at-1.049x-bf16", "int8-agree-0.9799-bf16"])
def test_serve_rule_edges(record, dtype):
    assert gen_tuned.serve_row(record)["dtype"] == dtype


def test_train_rows_keep_the_best_of_duplicates():
    recs = [{"model": "vip", "train_fps": 100.0, "train_batch": 32, "train_remat": False},
            {"model": "vip", "train_fps": 120.5, "train_batch": 32, "train_remat": True},
            {"model": "vip", "train_fps": 110.0, "train_batch": 64, "train_remat": False},
            {"model": "gfnet", "train_error": "OutOfMemoryError: ..."}]
    rows = gen_tuned.train_rows(recs)
    assert rows == {"vip": {"factory": "ViP", "remat": True, "batch": 32, "img_s": 120.5}}


def test_serve_rows_skip_other_records():
    recs = [_serving(), {"model": "mlp_mixer", "arm": "a", "fps": 1.0},
            {"model": "not_a_config", "fps": 1.0}, {"model": "vip", "train_fps": 1.0}]
    assert list(gen_tuned.serve_rows(recs)) == ["mlp_mixer"]


def test_committed_sweeps_cover_every_config_once():
    for path in (gen_tuned.TRAIN_SWEEP, gen_tuned.SERVING_SWEEP):
        models = [r["model"] for r in gen_tuned.read_jsonl(path)]
        assert sorted(models) == KEYS, path


def test_committed_records_name_the_card_and_the_header_repeats_it():
    records = (gen_tuned.read_jsonl(gen_tuned.TRAIN_SWEEP)
               + gen_tuned.read_jsonl(gen_tuned.SERVING_SWEEP))
    for r in records:
        assert r["device"].startswith("cuda"), r["model"]
        assert r["card"] and r["card"] != "cpu" and r["power_limit"].endswith(" W"), r["model"]
    header = tuned.__doc__
    for c in gen_tuned.cards(records):
        assert c in " ".join(header.split())
    with pytest.raises(ValueError):
        gen_tuned.cards([{"model": "vip"}])


def test_committed_table_is_the_generators_output(tmp_path):
    text = gen_tuned.render(gen_tuned.read_jsonl(gen_tuned.TRAIN_SWEEP),
                            gen_tuned.read_jsonl(gen_tuned.SERVING_SWEEP))
    with open(gen_tuned.OUT) as f:
        assert f.read() == text
    # main writes the same text, and the module it writes imports with the rows
    out = tmp_path / "tuned_gen.py"
    assert gen_tuned.main(["--out", str(out)]) == 0
    assert out.read_text() == text
    spec = importlib.util.spec_from_file_location("tuned_gen", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SERVE == tuned.SERVE and mod.TRAIN == tuned.TRAIN
    assert mod.serve_settings("S2MLPv2") is mod.SERVE["s2_mlp_v2"]
    assert mod.train_settings("nope") is None
