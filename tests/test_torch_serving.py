"""The port's Predictor and MicroBatcher against jittor_mlp_tpu's, on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt

KW = dict(d_model=16, depth=1, patch_size=8, image_size=32, num_classes=10,
          use_pallas=False)


def _predictors(batch_size=4):
    j = jm.Predictor(jm.MLPMixerForImageClassification(**KW),
                     batch_size=batch_size, image_size=32, top_k=3, bf16=False)
    t = jt.Predictor(jt.MLPMixerForImageClassification(**KW, device="cpu"),
                     batch_size=batch_size, image_size=32, top_k=3, bf16=False)
    return j, t


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n,size", [(4, 32), (3, 32), (2, 48)],
                         ids=["full", "padded", "resized"])
def test_predict_matches_jax(n, size):
    jp, tp = _predictors()
    imgs = _images(n, size)
    jl, jprob = jp.predict(imgs)
    tl, tprob = tp.predict(imgs)
    assert tl.shape == tprob.shape == (n, 3)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)


def test_padding_is_invisible_and_oversize_raises():
    _, tp = _predictors()
    imgs = _images(4)
    l_all, p_all = tp.predict(imgs)
    l_one, p_one = tp.predict(imgs[1:2])
    np.testing.assert_array_equal(l_one[0], l_all[1])
    np.testing.assert_array_equal(p_one[0], p_all[1])
    with pytest.raises(ValueError):
        tp.predict(_images(5))


def test_options_and_default_dtype(monkeypatch):
    from jittor_mlp_tpu_torch import tuned

    model = jt.MLPMixerForImageClassification(**KW, device="cpu")
    with pytest.raises(ValueError):
        jt.Predictor(model, weights="int4")
    with pytest.raises(ValueError):
        jt.Predictor(model, compute="fp8")
    # a model without a SERVE row serves in bf16
    monkeypatch.setattr(tuned, "SERVE", {})
    p = jt.Predictor(model, batch_size=2, image_size=32, top_k=3)
    assert p.dtype == "bf16"
    assert next(p.model.parameters()).dtype.is_floating_point
    labels, probs = p.predict(_images(2))
    assert labels.shape == probs.shape == (2, 3)
    assert np.isfinite(probs).all()


def test_tuned_tables_resolve_by_key_or_factory(monkeypatch):
    from jittor_mlp_tpu_torch import tuned

    monkeypatch.setattr(tuned, "SERVE", {})
    monkeypatch.setattr(tuned, "TRAIN", {})
    for name in ("mlp_mixer", "MLPMixerForImageClassification"):
        assert tuned.serve_settings(name) is None
        assert tuned.train_settings(name) is None
    serve = {"factory": "MLPMixerForImageClassification", "dtype": "f32"}
    train = {"factory": "MLPMixerForImageClassification", "remat": False, "batch": 8}
    monkeypatch.setitem(tuned.SERVE, "mlp_mixer", serve)
    monkeypatch.setitem(tuned.TRAIN, "mlp_mixer", train)
    for name in ("mlp_mixer", "MLPMixerForImageClassification"):
        assert tuned.serve_settings(name) is serve
        assert tuned.train_settings(name) is train
    # a SERVE row sets Predictor's default dtype
    p = jt.Predictor(jt.MLPMixerForImageClassification(**KW, device="cpu"), batch_size=2)
    assert p.dtype == "f32"


def test_latency_stats_keys():
    _, tp = _predictors()
    assert tp.latency_stats() == {}
    tp.warmup()
    tp.predict(_images(2))
    s = tp.latency_stats()
    assert set(s) == {"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"}
    assert s["count"] == 2 and s["max_ms"] >= s["p50_ms"] > 0


def test_microbatcher_bit_identical_to_predict():
    _, tp = _predictors(batch_size=4)
    imgs = _images(8, seed=1)
    want = [tp.predict(imgs[i:i + 1]) for i in range(8)]
    results = [None] * 8
    with jt.MicroBatcher(tp, max_delay_ms=20.0) as mb:
        def worker(i):
            results[i] = mb.submit(imgs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        stats = mb.stats()
        with pytest.raises(ValueError):
            mb.submit(_images(1, size=16)[0])
    for (labels, probs), (wl, wp) in zip(results, want):
        np.testing.assert_array_equal(labels, wl[0])
        np.testing.assert_array_equal(probs, wp[0])
    assert stats["requests"] == 8 and stats["batches"] >= 2
    with pytest.raises(RuntimeError):
        mb.submit(imgs[0])


def _submit_all(mb, images):
    """Submit each image from a thread of its own; every thread finishes."""
    threads = [threading.Thread(target=mb.submit, args=(im,)) for im in images]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


def test_microbatcher_wait_counters_count_and_order():
    _, tp = _predictors(batch_size=4)
    with jt.MicroBatcher(tp, max_delay_ms=20.0) as mb:
        empty = mb.stats()
        mb.submit(_images(1)[0])  # alone: dispatched at its deadline
        alone = mb.stats()
        _submit_all(mb, _images(6, seed=2))
        s = mb.stats()
        queued, execs = mb._queue_wait.count, mb._exec_wait.count
    assert empty["queue_wait_ms"] == empty["exec_wait_ms"] == {} and empty["padded_rows"] == 0
    assert alone["queue_wait_ms"]["p50"] >= 20.0 and alone["padded_rows"] == 3
    assert s["requests"] == queued == 7 and s["batches"] == execs
    assert s["padded_rows"] == s["batches"] * 4 - 7 == sum(
        (4 - int(fill)) * c for fill, c in s["fill_hist"].items())
    for k in ("queue_wait_ms", "exec_wait_ms"):
        assert set(s[k]) == {"p50", "p99"} and 0.0 <= s[k]["p50"] <= s[k]["p99"]
    assert {"requests", "batches", "batch_size", "mean_fill", "fill_hist"} <= set(s)


class _SlowPredictor:
    """A predictor whose every call holds its worker for ``seconds``."""

    batch_size, seconds = 2, 0.1

    def predict(self, images):
        time.sleep(self.seconds)
        n = len(images)
        return np.zeros((n, 3), np.int64), np.ones((n, 3), np.float32)


def test_exec_wait_grows_behind_a_busy_worker():
    """Eight requests make at least four batches of two. One worker runs
    them one after the other, so the last waits behind at least two slow
    calls; eight workers start each at once."""
    waits = {}
    for in_flight in (1, 8):
        with jt.MicroBatcher(_SlowPredictor(), max_delay_ms=20.0, in_flight=in_flight) as mb:
            _submit_all(mb, np.zeros((8, 4, 4, 3), np.uint8))
            waits[in_flight] = mb.stats()["exec_wait_ms"]["p99"]
    assert waits[1] >= 1000 * _SlowPredictor.seconds
    assert waits[8] < waits[1]


# a Mixer whose blocks run the W8A8 kernel's twin on the CPU (bf16, eval)
KW8 = dict(d_model=64, depth=2, patch_size=8, image_size=32, num_classes=10)


def test_int8_predictor_matches_jax_int8_predictor():
    """compute="int8": the JAX Predictor runs its nnf W8A8 path on the CPU,
    the port its W8A8 block kernel's twin, so the bar is a band: top-1
    agreement ≥ 90% and top-k probabilities within 5e-2."""
    jp = jm.Predictor(jm.MLPMixerForImageClassification(**KW8), batch_size=8,
                      image_size=32, top_k=3, compute="int8")
    tp = jt.Predictor(jt.MLPMixerForImageClassification(**KW8, device="cpu"), batch_size=8,
                      image_size=32, top_k=3, compute="int8")
    assert jp.dtype == tp.dtype == "int8"
    imgs = _images(32, seed=2)
    jl, jprob = zip(*(jp.predict(imgs[i:i + 8]) for i in range(0, 32, 8)))
    tl, tprob = zip(*(tp.predict(imgs[i:i + 8]) for i in range(0, 32, 8)))
    jl, jprob, tl, tprob = map(np.concatenate, (jl, jprob, tl, tprob))
    assert (jl[:, 0] == tl[:, 0]).mean() >= 0.9
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=5e-2)


def test_weights_int8_predictor_matches_jax():
    """weights="int8": the same dequantized weights as the JAX Predictor
    (float32 serving here, so the two agree as the f32 Predictors do)."""
    jp = jm.Predictor(jm.MLPMixerForImageClassification(**KW), batch_size=4,
                      image_size=32, top_k=3, bf16=False, weights="int8")
    tp = jt.Predictor(jt.MLPMixerForImageClassification(**KW, device="cpu"), batch_size=4,
                      image_size=32, top_k=3, bf16=False, weights="int8")
    assert tp.dtype == "f32"
    imgs = _images(4, seed=3)
    jl, jprob = jp.predict(imgs)
    tl, tprob = tp.predict(imgs)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    # the patch conv (16, 3, 8, 8) is large enough to be quantized
    plain = jt.MLPMixerForImageClassification(**KW, device="cpu")
    assert not torch.equal(tp.model.patcher[0].weight, plain.patcher[0].weight)


def _serve_side_by_side(model):
    """An int8 and a bf16 Predictor on one model, driven from two threads at
    once, give what each gives alone."""
    p8 = jt.Predictor(model, batch_size=4, image_size=32, top_k=3, compute="int8")
    p16 = jt.Predictor(model, batch_size=4, image_size=32, top_k=3)
    assert (p8.dtype, p16.dtype) == ("int8", "bf16")
    imgs = _images(4, seed=4)
    want = {"int8": p8.predict(imgs), "bf16": p16.predict(imgs)}
    assert not np.array_equal(want["int8"][1], want["bf16"][1])
    got = {"int8": [], "bf16": []}

    def run(p):
        for _ in range(12):
            got[p.dtype].append(p.predict(imgs))

    threads = [threading.Thread(target=run, args=(p,)) for p in (p8, p16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for dtype, runs in got.items():
        assert len(runs) == 12
        for labels, probs in runs:
            np.testing.assert_array_equal(labels, want[dtype][0])
            np.testing.assert_array_equal(probs, want[dtype][1])


def test_int8_and_bf16_predictors_side_by_side():
    """An int8 and a bf16 Predictor on one model, driven from two threads at
    once, give what each gives alone: the int8 choice travels with the call
    and is not a flag one thread can switch under the other."""
    _serve_side_by_side(jt.MLPMixerForImageClassification(**KW8, device="cpu"))


# a gMLP whose blocks run the gMLP kernels' twins on the CPU (bf16, eval)
GKW = dict(d_model=32, d_ffn=64, depth=2, patch_size=8, image_size=32, num_classes=10)


def test_gmlp_int8_and_bf16_predictors_side_by_side():
    """The same for gMLP: its int8 Predictor runs the W8A8 gMLP block's twin,
    its bf16 Predictor the bf16 block's, from two threads at once."""
    from jittor_mlp_tpu_torch.ops.kernels import gmlp_block, gmlp_block_int8

    before = (gmlp_block.LAUNCHES, gmlp_block_int8.LAUNCHES)
    _serve_side_by_side(jt.gMLPForImageClassification(**GKW, device="cpu"))
    assert (gmlp_block.LAUNCHES, gmlp_block_int8.LAUNCHES) == before  # CPU: twins only


def test_gmlp_int8_predictor_matches_jax_int8_predictor():
    """compute="int8" on gMLP: the JAX Predictor runs its nnf W8A8 path on
    the CPU, the port its W8A8 block kernel's twin; top-1 agreement ≥ 90%
    and top-k probabilities within 5e-2."""
    jp = jm.Predictor(jm.gMLPForImageClassification(**GKW), batch_size=8, image_size=32,
                      top_k=3, compute="int8")
    tp = jt.Predictor(jt.gMLPForImageClassification(**GKW, device="cpu"), batch_size=8,
                      image_size=32, top_k=3, compute="int8")
    assert jp.dtype == tp.dtype == "int8"
    imgs = _images(16, seed=5)
    jl, jprob = zip(*(jp.predict(imgs[i:i + 8]) for i in range(0, 16, 8)))
    tl, tprob = zip(*(tp.predict(imgs[i:i + 8]) for i in range(0, 16, 8)))
    jl, jprob, tl, tprob = map(np.concatenate, (jl, jprob, tl, tprob))
    assert (jl[:, 0] == tl[:, 0]).mean() >= 0.9
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=5e-2)


def test_gmlp_weights_int8_predictor_matches_jax():
    """weights="int8" on gMLP (stacked spatial weights with two scale axes):
    the same dequantized weights as the JAX Predictor, served in float32."""
    kw = dict(GKW, use_pallas=False)
    jp = jm.Predictor(jm.gMLPForImageClassification(**kw), batch_size=4, image_size=32,
                      top_k=3, bf16=False, weights="int8")
    tp = jt.Predictor(jt.gMLPForImageClassification(**kw, device="cpu"), batch_size=4,
                      image_size=32, top_k=3, bf16=False, weights="int8")
    imgs = _images(4, seed=6)
    jl, jprob = jp.predict(imgs)
    tl, tprob = tp.predict(imgs)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    plain = jt.gMLPForImageClassification(**kw, device="cpu")
    key = "model.0.channel_proj1.weight"
    assert not torch.equal(tp.model.state_dict()[key], plain.state_dict()[key])


def test_serve_row_int8_selects_compute_int8(monkeypatch):
    from jittor_mlp_tpu_torch import tuned

    monkeypatch.setitem(tuned.SERVE, "mlp_mixer",
                        {"factory": "MLPMixerForImageClassification", "dtype": "int8"})
    p = jt.Predictor(jt.MLPMixerForImageClassification(**KW, device="cpu"), batch_size=2)
    assert p.dtype == "int8"
    p = jt.Predictor(jt.MLPMixerForImageClassification(**KW, device="cpu"), batch_size=2,
                     weights="int8")
    assert p.dtype == "bf16"  # weights= given: the row does not add compute="int8"


def test_factory_without_card_or_cpu_device_raises():
    if torch.cuda.is_available():
        assert jt.MLPMixerForImageClassification(**KW).device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        jt.Predictor(jt.MLPMixerForImageClassification(**KW))
    with pytest.raises(RuntimeError):
        jt.ResMLPForImageClassification(d_model=16, depth=1, patch_size=8, image_size=32)
