"""The port's eval and serve examples, metrics logger and timing, on the CPU.

- ``examples/eval.main`` runs its synthetic smoke and prints top-1;
- ``evaluate`` over a 20-image folder (a ragged last batch) counts the
  hits that the same JAX weights count through the JAX package's folder
  pipeline and ``apply``;
- ``examples/serve.make_server`` on port 0 in a thread, with and without
  micro-batching: /classify answers what ``Predictor.predict`` answers on
  the decoded image, /stats is JSON, a malformed body gets a one-line 400;
- ``MetricsLogger`` writes the JAX logger's bytes for the same logs, and
  ``read_metrics`` reads them back the same;
- ``utils.timing.throughput`` on the CPU returns a positive rate.
"""

import http.client
import io
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu.data import BatchIterator as JBatchIterator
from jittor_mlp_tpu.data import ImageFolderDataset as JImageFolderDataset
from jittor_mlp_tpu.utils import metrics as jmetrics
from jittor_mlp_tpu_torch.data import BatchIterator, ImageFolderDataset
from jittor_mlp_tpu_torch.examples import eval as teval
from jittor_mlp_tpu_torch.examples import serve as tserve
from jittor_mlp_tpu_torch.utils import metrics as tmetrics
from jittor_mlp_tpu_torch.utils.timing import throughput

MIXER = dict(image_size=32, patch_size=8, d_model=32, depth=2, num_classes=10)
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])


def test_eval_main_synthetic_smoke(capsys):
    top1, top5, n, img_s = teval.main(["--synthetic", "--device", "cpu", "--image-size", "32"])
    out = capsys.readouterr().out
    assert "top-1" in out and "img/s" in out
    assert n == 3 * 64 and 0 <= top1 <= top5 <= 1 and img_s > 0


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """10 classes of 2 PNGs each, of sizes around 32."""
    root = tmp_path_factory.mktemp("evalset")
    rng = np.random.default_rng(0)
    for c in range(10):
        os.makedirs(root / f"c{c}")
        for k in range(2):
            h, w = (32, 40) if k else (36, 32)
            with open(root / f"c{c}" / f"{k}.png", "wb") as f:
                f.write(_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
    return str(root)


def test_evaluate_counts_the_hits_of_jax_apply(folder):
    jmodel = jm.MLPMixerForImageClassification(**MIXER, seed=3)
    tmodel = jt.MLPMixerForImageClassification(**MIXER, seed=4, device="cpu").eval()
    tmodel.load_torch_state_dict(jmodel.export_torch_state_dict(tensors=False))
    batches = BatchIterator(ImageFolderDataset(folder, decode_size=32), 8, shuffle=False,
                            drop_last=False)
    top1, top5, n, img_s = teval.evaluate(tmodel, batches, 8, torch.float32)
    assert n == 20 and img_s > 0
    hit1 = hit5 = 0
    for b in JBatchIterator(JImageFolderDataset(folder, decode_size=32), 8, shuffle=False,
                            drop_last=False):
        x = ((b["image"].astype(np.float32) / 255.0 - MEAN) / STD).transpose(0, 3, 1, 2)
        logits = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(x, jnp.float32)))
        top = np.argsort(-logits, axis=-1)[:, :5]
        hit1 += int((top[:, 0] == b["label"]).sum())
        hit5 += int((top == b["label"][:, None]).any(-1).sum())
    assert (round(top1 * n), round(top5 * n)) == (hit1, hit5)
    assert hit5 > hit1  # the top-5 count sees more than the top-1


def test_evaluate_pads_the_tail_without_counting_it():
    model = jt.MLPMixerForImageClassification(**MIXER, device="cpu").eval()
    imgs = np.random.default_rng(1).integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    labels = np.arange(11) % 10
    whole = teval.evaluate(model, [{"image": imgs, "label": labels}], 11, torch.float32)
    top5s = []
    split = teval.evaluate(model, [{"image": imgs[:8], "label": labels[:8]},
                                   {"image": imgs[8:], "label": labels[8:]}], 8,
                           torch.float32, top5_out=top5s)
    assert whole[:3] == split[:3] and split[2] == 11
    assert [t.shape for t in top5s] == [(8, 5), (3, 5)]


@pytest.fixture(params=[1, 4], ids=["single", "microbatched"])
def server(request):
    args = tserve.parse_args(["--device", "cpu", "--port", "0", "--image-size", "32",
                              "--batch", str(request.param), "--top-k", "3"])
    model = jt.MLPMixerForImageClassification(**MIXER, device="cpu")
    srv, pred, batcher = tserve.make_server(args, model=model)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1], pred, batcher
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    if batcher is not None:
        batcher.close()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.reason, r.read()
    finally:
        conn.close()


def test_server_answers_what_predict_answers(server):
    port, pred, batcher = server
    rng = np.random.default_rng(2)
    bodies = [_png(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)) for _ in range(6)]
    answers = [None] * len(bodies)

    def client(i):
        answers[i] = _request(port, "POST", "/classify", bodies[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for body, (status, _, blob) in zip(bodies, answers):
        assert status == 200
        got = json.loads(blob)["top_k"]
        labels, probs = pred.predict(tserve.decode(body, 32))
        assert [e["label"] for e in got] == labels[0].tolist()
        np.testing.assert_allclose([e["prob"] for e in got], probs[0], rtol=0, atol=1e-6)
    status, _, blob = _request(port, "GET", "/stats")
    stats = json.loads(blob)
    assert status == 200 and stats["count"] >= len(bodies) and "p99_ms" in stats
    assert ("batcher" in stats) == (batcher is not None)
    if batcher is not None:
        assert stats["batcher"]["requests"] == len(bodies)


def test_server_refuses_a_bad_body_in_one_line(server):
    port = server[0]
    status, reason, blob = _request(port, "POST", "/classify", b"\x89PNG\r\n\x1a\nbroken\nlines")
    assert status == 400 and reason == "bad request"
    assert _request(port, "GET", "/nowhere")[0] == 404


def test_decode_falls_back_to_pil_with_the_same_geometry():
    """A BMP (which the native decoder refuses) decodes through PIL to the
    pixels the native decoder gives the same image as PNG."""
    arr = np.random.default_rng(3).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="BMP")
    got = tserve.decode(buf.getvalue(), 40)
    np.testing.assert_array_equal(got, tserve.decode(_png(arr), 40))
    np.testing.assert_array_equal(got[0], arr[:, 8:48])


def _clock(monkeypatch):
    ticks = iter(np.arange(1000.0, 2000.0, 0.1234567))
    monkeypatch.setattr("time.time", lambda: float(next(ticks)))


def test_metrics_logger_writes_the_jax_bytes(tmp_path, monkeypatch):
    logs = [(1, {"loss": 2.5, "lr": np.float32(1e-3)}), (2, {"loss": torch.tensor(1.25)}),
            (3, {"loss": 0.5, "acc": 1})]
    files = {}
    for pkg, mod in (("jax", jmetrics), ("torch", tmetrics)):
        _clock(monkeypatch)
        path = str(tmp_path / pkg / "m.jsonl")
        logger = mod.MetricsLogger(path, flush_every=2, extra={"model": "mixer", "seed": 0})
        for step, scalars in logs:
            logger.log(step, **{k: float(v) for k, v in scalars.items()})
        logger.flush()
        files[pkg] = path
    with open(files["torch"], "rb") as f, open(files["jax"], "rb") as g:
        assert f.read() == g.read()
    assert tmetrics.read_metrics(files["torch"]) == jmetrics.read_metrics(files["jax"])


def test_metrics_logger_takes_tensors(tmp_path):
    logger = tmetrics.MetricsLogger(str(tmp_path / "m.jsonl"))
    rec = logger.log(0, loss=torch.tensor(0.75), acc=np.float64(0.5))
    assert rec["loss"] == 0.75 and rec["acc"] == 0.5
    assert tmetrics.read_metrics(str(tmp_path / "m.jsonl"))["loss"] == [0.75]


def test_throughput_on_the_cpu_is_positive():
    model = jt.MLPMixerForImageClassification(**MIXER, device="cpu").eval()
    rate = throughput(lambda x: model.forward(x), (2, 3, 32, 32), iters=2, dtype=torch.float32,
                      repeats=2, device="cpu")
    assert rate > 0
