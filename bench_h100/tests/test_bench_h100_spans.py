"""The readers of the program's spans (``spans.py``, the ``upload_*.infer``
and ``*_ms.train`` metrics) on synthetic Kineto events, and on a traced
small run of the real program on the CPU: the names they look up are the
names the program records."""

import types

import bench_small
import pytest
from test_bench_h100_trace import Ev

from bench_h100 import harness, spans, trace

MS = 1_000_000
INFER = ("upload_ms.infer", "upload_idle.infer")
TRAIN = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train")


def _read(name, t):
    return harness.load_module(harness.HERE, "metrics", name).read(types.SimpleNamespace(trace=t))


def _infer_events():
    """Two predict calls: each uploads (a pageable copy under aten::copy_,
    linked to it), then runs a kernel; a kernel launched before the first
    upload still runs in its first 3 ms, and the top-k download copies
    after the span."""
    return [
        Ev("window", "CPU", "user_annotation", 0, 100 * MS, corr=1),
        Ev("aten::mm", "CPU", "cpu_op", 0, 1 * MS, corr=2),
        Ev("gemm", "CUDA", "kernel", 1 * MS, 5 * MS, linked=2),
        Ev(spans.UPLOAD, "CPU", "user_annotation", 2 * MS, 12 * MS, corr=3),
        Ev("aten::copy_", "CPU", "cpu_op", 3 * MS, 11 * MS, corr=4),
        Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", "gpu_memcpy", 4 * MS, 11 * MS, linked=4),
        Ev("aten::mm", "CPU", "cpu_op", 13 * MS, 14 * MS, corr=5),
        Ev("block", "CUDA", "kernel", 14 * MS, 30 * MS, linked=5),
        Ev("aten::copy_", "CPU", "cpu_op", 14 * MS, 31 * MS, corr=6),
        Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", "gpu_memcpy", 30 * MS, 31 * MS, linked=6),
        Ev(spans.UPLOAD, "CPU", "user_annotation", 42 * MS, 52 * MS, corr=7),
        Ev("aten::copy_", "CPU", "cpu_op", 43 * MS, 51 * MS, corr=8),
        Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", "gpu_memcpy", 44 * MS, 50 * MS, linked=8),
        Ev("aten::mm", "CPU", "cpu_op", 52 * MS, 53 * MS, corr=9),
        Ev("block", "CUDA", "kernel", 53 * MS, 70 * MS, linked=9),
    ]


def _train_events(steps=2):
    """``steps`` steps of 30 ms: forward on the main thread, the backward's
    ops on the autograd engine's thread (2) while the main thread waits in
    the backward span, the optimizer on the main thread; a fill launched in
    the forward; no kernel outside the spans."""
    ev, corr = [Ev("window", "CPU", "user_annotation", 0, 100 * MS, corr=1)], 10
    for i in range(steps):
        t0 = 5 * MS + i * 30 * MS
        parts = [(spans.FORWARD, 1, [(1, "aten::mm", "kernel", 2, 8),
                                     (2, "aten::zero_", "gpu_memset", 8, 9)]),
                 (spans.BACKWARD, 2, [(11, "aten::mul", "kernel", 12, 20),
                                      (13, "aten::mm", "kernel", 20, 24)]),
                 (spans.OPTIMIZER, 1, [(25, "aten::_foreach_add_", "kernel", 26, 28)])]
        for (name, thread, ops), (a, b) in zip(parts, [(0, 10), (10, 25), (25, 29)]):
            ev.append(Ev(name, "CPU", "user_annotation", t0 + a * MS, t0 + b * MS, corr=corr))
            corr += 1
            for at, op, act, s, e in ops:
                ev.append(Ev(op, "CPU", "cpu_op", t0 + at * MS, t0 + (at + 1) * MS,
                             thread=thread, corr=corr))
                dev = "Memset (Device)" if act == "gpu_memset" else op + "_dev"
                ev.append(Ev(dev, "CUDA", act, t0 + s * MS, t0 + e * MS, linked=corr))
                corr += 1
    return ev


def test_a_copy_counts_for_the_upload_through_the_op_that_launched_it():
    t = trace.Trace(_infer_events())
    assert spans.calls(t, spans.UPLOAD) == 2
    # the two uploads' copies (7 and 6 ms); not the kernels, not the download
    assert _read("upload_ms.infer", t) == pytest.approx((7 + 6) / 2)
    assert spans.device_s(t, spans.intervals(t, spans.UPLOAD)) == pytest.approx(0.013)


def test_idle_under_the_upload_is_its_interval_less_the_kernels():
    t = trace.Trace(_infer_events())
    # 2–12 less the kernel's 1–5, and 42–52 with no kernel: 7 + 10 ms of 100
    assert spans.idle_s(t, spans.intervals(t, spans.UPLOAD)) == pytest.approx(0.017)
    assert _read("upload_idle.infer", t) == pytest.approx(17.0)
    assert _read("upload_idle.infer", t) <= 100 * (1 - t.busy_s / t.window_s)


def test_a_backward_kernel_launched_from_another_thread_counts():
    t = trace.Trace(_train_events(steps=1))
    assert _read("bwd_ms.train", t) == pytest.approx(8 + 4)
    assert _read("fwd_ms.train", t) == pytest.approx(6 + 1)  # the fill too
    assert _read("opt_ms.train", t) == pytest.approx(2)


def test_the_three_phases_account_for_every_kernel_of_the_steps():
    steps = 3
    t = trace.Trace(_train_events(steps))
    total = sum(_read(m, t) for m in TRAIN) * steps / 1000
    assert total == pytest.approx(sum(e - s for s, e, *_ in t.gpu) / 1e9)
    assert total == pytest.approx(t.busy_s + steps * 0.001)  # busy counts no fill


def test_spans_are_counted_where_they_begin_in_the_window():
    ev = _infer_events()
    ev[0] = Ev("window", "CPU", "user_annotation", 20 * MS, 100 * MS, corr=1)
    t = trace.Trace(ev)
    assert spans.calls(t, spans.UPLOAD) == 1
    assert spans.intervals(t, spans.UPLOAD) == [[42 * MS, 52 * MS]]


@pytest.mark.parametrize("name", INFER + TRAIN)
def test_no_span_no_reading(name):
    t = trace.Trace([Ev("window", "CPU", "user_annotation", 0, 10 * MS, corr=1),
                     Ev("aten::mm", "CPU", "cpu_op", 1 * MS, 2 * MS, corr=2),
                     Ev("gemm", "CUDA", "kernel", 2 * MS, 4 * MS, linked=2)])
    assert _read(name, t) is None
    assert _read(name, None) is None


@pytest.mark.parametrize("cell,names", [("mixer_b16.infer_b256", INFER),
                                        ("mixer_b16.train_b128", TRAIN)])
def test_the_program_records_the_spans_the_readers_look_up(cell, names):
    """A traced small run of the real program on the CPU: every new metric
    of the cell finds its span (no device, so no device time)."""
    pytest.importorskip("jittor_mlp_tpu_torch")
    out = bench_small.run(bench_small.cell(cell), seconds=0.2, trace=1)
    for name in names:
        assert name in out["metrics"], (name, sorted(out["metrics"]))
    if cell.endswith("train_b128"):
        assert all(out["metrics"][n]["value"] == 0.0 for n in names)
