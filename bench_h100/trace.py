"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device busy time, the traced window, device time by kernel and by the
program's ops that launched it, and the idle gaps by what the host did.

The trace is read from Kineto's own event list (``kineto_results``), not
from ``prof.events()``, whose tree of Python objects takes minutes over a
window of some hundred thousand launches.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "window"
GPU_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e, dev):
    """The Kineto activity of event ``e`` on ``dev`` ("CPU" or "CUDA"):
    ``cpu_op``, ``user_annotation``, ``cuda_runtime``, ``kernel``,
    ``gpu_memcpy``, ``gpu_memset`` or ``gpu_user_annotation``, from its
    flags and name (the events of PyTorch 2.11, on the card, carry no
    ``activity_type()``)."""
    name = e.name()
    if dev == "CPU":
        if e.is_user_annotation():
            return "user_annotation"
        return "cuda_runtime" if name.startswith(("cuda", "cu")) and name[2:3] != ":" else "cpu_op"
    if e.is_user_annotation():
        return "gpu_user_annotation"
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


class Trace:
    """One traced window.

    ``busy_s``: seconds of the window in which a kernel ran on the device
    (the union of kernel intervals, so overlapping kernels count once);
    ``window_s``: the length of the ``window`` span the harness wraps
    around the measured traffic; ``device_ops``: seconds by the name of
    each device operation (kernels, copies, fills) inside the window."""

    def __init__(self, events):
        cpu, gpu, window, kinds, spans = [], [], None, defaultdict(int), set()
        for e in events:
            dev = str(e.device_type()).split(".")[-1]
            act = _kind(e, dev)
            kinds[f"{dev} {act}"] += 1
            if dev == "CPU":
                if e.name() == WINDOW_SPAN and act == "user_annotation":
                    if window is None or e.end_ns() - e.start_ns() > window[1] - window[0]:
                        window = (e.start_ns(), e.end_ns())
                elif act in ("cpu_op", "user_annotation"):
                    cpu.append((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name(),
                                e.correlation_id()))
                    if act == "user_annotation":
                        spans.add(e.name())
            elif act in GPU_ACTIVITIES:
                gpu.append((e.start_ns(), e.end_ns(), e.name(), act, e.linked_correlation_id()))
        self.kinds, self._spans = dict(kinds), spans
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span; events by "
                               f"(device, activity): {dict(kinds)}")
        ws, we = window
        self.window_s = (we - ws) / 1e9
        self._ws, self._we = ws, we
        self.gpu = sorted((max(s, ws), min(t, we), n, a, c) for s, t, n, a, c in gpu
                          if t > ws and s < we)
        self.cpu = cpu
        self._by_id = {c[4]: c for c in cpu}
        self._threads = defaultdict(list)
        for c in sorted(cpu):
            self._threads[c[2]].append(c)
        self._starts = {t: [c[0] for c in cs] for t, cs in self._threads.items()}
        kernels = [g for g in self.gpu if g[3] == "kernel"]
        self.busy_intervals = _union((s, t) for s, t, *_ in kernels)
        self.busy_s = sum(t - s for s, t in self.busy_intervals) / 1e9
        self.device_ops = defaultdict(float)
        for s, t, n, _, _ in self.gpu:
            self.device_ops[n] += (t - s) / 1e9
        self._kernels = kernels

    def _enclosing(self, thread, at, prefix=None):
        """The innermost CPU op or span on ``thread`` that covers time ``at``
        (with ``prefix``: the innermost whose name starts with it), or None."""
        cs, starts = self._threads.get(thread), self._starts.get(thread)
        if not cs:
            return None
        i = bisect.bisect_right(starts, at) - 1
        steps = 0
        while i >= 0 and steps < 4096:
            c = cs[i]
            if c[1] >= at and (prefix is None or c[3].startswith(prefix)):
                return c
            i -= 1
            steps += 1
        return None

    def op_device(self, prefix):
        """(device seconds, calls): the kernels launched inside a CPU op whose
        name starts with ``prefix`` (by the op each kernel's launch is
        linked to, or an op that encloses that one on its thread), and the
        number of such ops that began in the window."""
        total, inside = 0.0, {}
        for s, t, _, _, corr in self._kernels:
            op = self._by_id.get(corr)
            if op is None:
                continue
            key = op[4]
            if key not in inside:
                inside[key] = (op[3].startswith(prefix)
                               or self._enclosing(op[2], op[0], prefix) is not None)
            if inside[key]:
                total += (t - s) / 1e9
        calls = sum(1 for c in self.cpu if c[3].startswith(prefix) and self._ws <= c[0] < self._we
                    and self._enclosing(c[2], c[0] - 1, prefix) is None)
        return total, calls

    def _any_op(self, at):
        """The shortest CPU op (not a span) on any thread that covers time
        ``at``, or None."""
        found = [c for t in self._threads for c in [self._enclosing(t, at)] if c is not None]
        ops = [c for c in found if c[3] not in self._spans]
        return min(ops, key=lambda c: c[1] - c[0]) if ops else None

    def idle_gaps(self, longest=2000):
        """[(label, seconds)]: the idle time of the ``longest`` idle gaps of
        the window (no kernel running), summed by what the host was doing:
        the innermost op or span, at the gap's middle, on the thread that
        launched the kernel that ended the gap; where that thread ran none,
        the shortest op running on any thread; else "no op on any thread"
        (the host waiting, or in Python outside any op)."""
        edges = [self._ws, *[x for iv in self.busy_intervals for x in iv], self._we]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]),
                      reverse=True)[:longest]
        starts = [k[0] for k in self._kernels]
        out = defaultdict(float)
        for dur, a, b in gaps:
            j = bisect.bisect_left(starts, b)
            label = "end of window"
            if j < len(self._kernels):
                op = self._by_id.get(self._kernels[j][4])
                mid = (a + b) // 2
                inner = (self._enclosing(op[2], mid) if op else None) or self._any_op(mid)
                label = inner[3] if inner else "no op on any thread"
            out[label] += dur / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])

    def breakdown(self, top=10):
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:top]]}


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def reduce(prof):
    """The ``Trace`` of a stopped ``torch.profiler.profile``."""
    return Trace(prof.profiler.kineto_results.events())
