"""The port's spans (``utils/spans.py``) on the CPU: one upload span a
``Predictor.predict``, the forward, backward and optimizer spans of each
train step in order, nothing entered while no profiler records, and names
that trace readers cannot take for the port's kernel ops."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jittor_mlp_tpu_torch as jt
from bench_h100 import spans as bench_spans
from jittor_mlp_tpu_torch.parallel import make_train_step
from jittor_mlp_tpu_torch.parallel.mesh import make_mesh
from jittor_mlp_tpu_torch.utils import spans

KW = dict(d_model=16, depth=1, patch_size=8, image_size=32, num_classes=10, use_pallas=False)
TINY = dict(d_model=32, depth=2, patch_size=8, image_size=16, token_dim=24, num_classes=10,
            seed=11)
STEP = (spans.FORWARD, spans.BACKWARD, spans.OPTIMIZER)


def _profiled(fn):
    """[(name, start ns, end ns)] of the port's spans that ``fn()`` records
    under ``torch.profiler``, by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name().startswith("jmt.")),
                  key=lambda s: s[1])


def _predictor():
    return jt.Predictor(jt.MLPMixerForImageClassification(**KW, device="cpu"),
                        batch_size=4, image_size=32, top_k=3, bf16=False)


def _images(n):
    return np.random.default_rng(0).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _batch():
    g = torch.Generator().manual_seed(3)
    return {"image": torch.randn(4, 3, 16, 16, generator=g),
            "label": torch.randint(0, 10, (4,), generator=g)}


def _step(mesh=None):
    model = jt.MLPMixerForImageClassification(**TINY, device="cpu")
    return make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3), mesh=mesh)


def _in_order(seen, steps):
    assert [n for n, _, _ in seen] == list(STEP) * steps
    for (_, _, end), (_, start, _) in zip(seen, seen[1:]):
        assert end <= start, "the spans of a step do not overlap"


def test_each_predict_records_one_upload_span():
    p = _predictor()
    p.predict(_images(4))  # warm
    seen = _profiled(lambda: [p.predict(_images(n)) for n in (4, 3, 1)])
    assert [n for n, _, _ in seen] == [spans.UPLOAD] * 3


def test_each_train_step_records_forward_backward_optimizer_in_order():
    step, batch = _step(), _batch()
    step(batch)
    _in_order(_profiled(lambda: [step(batch) for _ in range(2)]), 2)


@pytest.fixture
def world_of_one():
    """A gloo world of this process alone, torn down after the test."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_the_mesh_step_records_the_same_spans(world_of_one):
    step, batch = _step(world_of_one), _batch()
    step(batch)
    _in_order(_profiled(lambda: step(batch)), 1)


def test_no_span_is_entered_while_no_profiler_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert all(spans.span(n) is spans._OFF for n in spans.NAMES)
    _predictor().predict(_images(2))
    _step()(_batch())


def test_span_names_cannot_be_taken_for_kernel_ops():
    assert len(set(spans.NAMES)) == len(spans.NAMES) == 4
    for name in spans.NAMES:
        assert name.startswith("jmt.") and not name.startswith("jittor_mlp_tpu_torch::")


@pytest.mark.parametrize("name", ["UPLOAD", "FORWARD", "BACKWARD", "OPTIMIZER"])
def test_the_benchmark_reads_the_names_the_port_records(name):
    assert getattr(bench_spans, name) == getattr(spans, name)
