"""The trace reduction on a synthetic Kineto event list: busy time as the
union of kernel intervals inside the window span, device time of the
kernels launched inside the program's ops, and idle gaps labelled by what
the host did."""

import pytest

from bench_h100 import trace


class Ev:
    def __init__(self, name, dev, act, start, end, thread=1, corr=0, linked=0):
        self._n, self._d, self._a = name, dev, act
        self._s, self._e, self._t, self._c, self._l = start, end, thread, corr, linked

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def is_user_annotation(self):
        return self._a in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _events():
    ms = 1_000_000
    return [
        Ev("window", "CPU", "user_annotation", 0, 100 * ms, corr=1),
        Ev("predict", "CPU", "user_annotation", 1 * ms, 99 * ms, corr=2),
        Ev("aten::copy_", "CPU", "cpu_op", 2 * ms, 30 * ms, corr=3),
        Ev("jittor_mlp_tpu_torch::fused_mixer_block", "CPU", "cpu_op", 31 * ms, 40 * ms, corr=4),
        Ev("aten::copy_", "CPU", "cpu_op", 32 * ms, 33 * ms, corr=5),
        Ev("jittor_mlp_tpu_torch::fused_mixer_block", "CPU", "cpu_op", 41 * ms, 50 * ms, corr=6),
        Ev("aten::mm", "CPU", "cpu_op", 51 * ms, 52 * ms, corr=7),
        Ev("cudaLaunchKernel", "CPU", "cuda_runtime", 31 * ms, 32 * ms, corr=900),
        Ev("predict", "CUDA", "gpu_user_annotation", 1 * ms, 99 * ms),
        Ev("Memcpy HtoD (Pageable -> Device)", "CUDA", "gpu_memcpy", 3 * ms, 30 * ms, linked=3),
        Ev("block_a", "CUDA", "kernel", 35 * ms, 45 * ms, linked=4),
        Ev("copy_kernel", "CUDA", "kernel", 44 * ms, 46 * ms, linked=5),  # inside the op
        Ev("block_b", "CUDA", "kernel", 50 * ms, 60 * ms, linked=6),
        Ev("gemm", "CUDA", "kernel", 80 * ms, 90 * ms, linked=7),
        Ev("late", "CUDA", "kernel", 99 * ms, 120 * ms, linked=7),  # clipped at the window
    ]


def test_a_waiting_host_reads_as_such():
    ms = 1_000_000
    t = trace.Trace([Ev("window", "CPU", "user_annotation", 0, 10 * ms, corr=1),
                     Ev("submit", "CPU", "user_annotation", 0, 10 * ms, thread=2, corr=2),
                     Ev("aten::mm", "CPU", "cpu_op", 7 * ms, 8 * ms, thread=3, corr=3),
                     Ev("gemm", "CUDA", "kernel", 8 * ms, 9 * ms, linked=3)])
    assert dict(t.idle_gaps()) == pytest.approx({"no op on any thread": 0.008,
                                                 "end of window": 0.001})


def test_busy_window_and_device_ops():
    t = trace.Trace(_events())
    assert t.window_s == pytest.approx(0.1)
    # kernels 35–46, 50–60, 80–90, 99–100: the memcpy and the annotation are not busy
    assert t.busy_s == pytest.approx(0.032)
    assert t.device_ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(0.027)
    assert "predict" not in t.device_ops


def test_op_device_counts_kernels_inside_the_programs_ops():
    t = trace.Trace(_events())
    device_s, calls = t.op_device("jittor_mlp_tpu_torch::")
    assert calls == 2
    assert device_s == pytest.approx(0.010 + 0.002 + 0.010)


def test_idle_gaps_by_host_activity():
    t = trace.Trace(_events())
    gaps = dict(t.idle_gaps())
    # 0–35 ends with block_a (op 4): at 17.5 ms its thread ran aten::copy_ (the upload)
    assert gaps["aten::copy_"] == pytest.approx(0.035)
    assert gaps["jittor_mlp_tpu_torch::fused_mixer_block"] == pytest.approx(0.004)
    assert gaps["predict"] == pytest.approx(0.020 + 0.009)  # between the ops, in the span
    assert sum(gaps.values()) == pytest.approx(0.1 - 0.032)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "Memcpy HtoD (Pageable -> Device)"
    assert len(b["idle_gaps"]) <= 10
