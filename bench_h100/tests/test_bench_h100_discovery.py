"""The harness finds every cell's configuration, traffic, reference, limits
and per-layer readers by name from BENCHMARK.json, and a new file plus an
entry is picked up with no edit; BENCHMARK.json keeps to the contract's
shape."""

import json
import os
import re
import shutil

import pytest

from bench_h100 import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    c = harness.Cell(name)
    assert c.cfg["name"] == c.workload["config"]
    assert c.traffic["kind"] in ("closed", "train")
    assert callable(c.ref.forward) and callable(c.ref.flops_per_image)
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert c.per_layer, "every cell reports a per-layer metric"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(c.limits), "every cell has its correctness limits"
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves a metric its cell reports"


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/") and not c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_files_and_entry_picked_up(tmp_path):
    """A later PR adds a mix, a configuration, a metric and a cell as files
    and entries; the harness finds them with no edit of its own."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "bench_h100"), root / "bench_h100")
    bench = json.loads(json.dumps(BENCH))
    here = root / "bench_h100"
    traffic = json.loads((here / "traffic" / "infer_closed.json").read_text())
    traffic["batch_size"] = 64
    (here / "traffic" / "infer_closed_b64.json").write_text(json.dumps(traffic))
    cfg = json.loads((here / "configs" / "mixer_b16.json").read_text())
    cfg.update(name="mixer_s16", args=dict(cfg["args"], d_model=512, depth=8, token_dim=256))
    (here / "configs" / "mixer_s16.json").write_text(json.dumps(cfg))
    (here / "metrics" / "images.count.py").write_text(
        "def read(run):\n    return float(run.window['images'])\n")
    bench["configs"].append({"name": "mixer_s16", "source": "https://arxiv.org/abs/2105.01601",
                             "file": "bench_h100/configs/mixer_s16.json", "reduced": [],
                             "why": "a smaller Mixer"})
    bench["workloads"].append({"name": "mixer_s16.infer_b64", "config": "mixer_s16",
                               "traffic": "infer_closed_b64", "chips": 1, "why": "b64"})
    bench["per_layer"].append({"name": "images.count", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "request path",
                               "moves": "infer_img_s", "workloads": ["mixer_s16.infer_b64"]})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_img_s":
            m["workloads"].append("mixer_s16.infer_b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.Cell("mixer_s16.infer_b64", str(root))
    assert c.traffic["batch_size"] == 64 and c.cfg["args"]["d_model"] == 512
    assert "images.count" in c.readers and "mfu.infer" not in c.readers
    assert {m["name"] for m in c.end_to_end} == {"infer_img_s", "setup_s"}
    assert c.readers["images.count"](type("R", (), {"window": {"images": 5}})) == 5.0
    with pytest.raises(KeyError):
        harness.Cell("no_such.cell", str(root))
