"""The check catches a broken timed path: each cell's run, driven on the CPU
at small widths past the look for a card, with the path broken underneath,
comes out not correct under the cell's limits, and the sound run comes out
correct. The faults: an answer altered where it is produced, half of the
batch left out (its answers, or its rows of the loss), a step that leaves
the state unchanged."""

import numpy as np
import pytest
import torch

import bench_small

program = pytest.importorskip("jittor_mlp_tpu_torch")
SERVED = ["mixer_b16.infer_b256", "resmlp_s24.infer_b256"]


def _alter_one(monkeypatch):
    real = program.Predictor.predict

    def predict(self, images):  # one answer of each call: its first label
        labels, probs = real(self, images)
        labels = labels.copy()
        labels[0, 0] = (labels[0, 0] + 1) % 10
        return labels, probs

    monkeypatch.setattr(program.Predictor, "predict", predict)


def _half_answers(monkeypatch):
    real = program.Predictor.predict

    def predict(self, images):
        labels, probs = real(self, images)
        h = (len(labels) + 1) // 2
        if len(labels) > 1:
            labels, probs = labels.copy(), probs.copy()
            labels[h:], probs[h:] = labels[:len(labels) - h], probs[:len(labels) - h]
        return labels, probs

    monkeypatch.setattr(program.Predictor, "predict", predict)


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("fault", [None, "altered", "half"])
def test_served_cells(name, fault, monkeypatch):
    c = bench_small.cell(name)
    if fault == "altered":
        _alter_one(monkeypatch)
    elif fault == "half":
        _half_answers(monkeypatch)
    out = bench_small.run(c, seconds=0.5)
    assert out["correct"] is (fault is None), out["check"]


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from jittor_mlp_tpu_torch.parallel import train

    real = train._loss_and_sites

    def half(logits, labels):
        h = len(labels) // 2
        return train.cross_entropy_loss(logits[:h], labels[:h])

    monkeypatch.setattr(train, "_loss_and_sites",
                        lambda *a, **k: real(*a, **dict(k, loss=half)))


@pytest.mark.parametrize("fault", [None, "unchanged", "half"])
def test_train_cell(fault, monkeypatch):
    """In float32: at these widths a bf16 step's own gaps already pass
    the limits set at the cell's size, so the sound run could not show
    that the check passes what it should."""
    c = bench_small.cell("mixer_b16.train_b128", compute_dtype="float32")
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif fault == "half":
        _half_batch(monkeypatch)
    out = bench_small.run(c, seconds=0.3)
    assert out["correct"] is (fault is None), out["check"]
    if fault == "unchanged":
        assert np.isclose(out["check"]["change_gap"]["value"], 1.0)
        assert np.isclose(out["check"]["tail_change_gap"]["value"], 1.0)
