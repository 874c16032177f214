"""What the program's own spans give in a reduced trace (``trace.Trace``).

The port records spans (``record_function``, user annotations in the
trace) around the work of its layers while a profiler records: the upload
inside ``Predictor.predict`` and the train step's forward, backward and
optimizer. The names are the program's, copied here so that the benchmark
imports nothing of it to read a trace; a CPU test holds them equal.

A device operation (kernel, copy or fill) counts as launched inside a span
when the CPU op it links to began inside one of that span's intervals, on
any thread: the autograd engine launches the backward's kernels from a
thread of its own, and the benchmark drives one call at a time. Where the
trace holds no such span (a program without it), each reading is None.
"""

from __future__ import annotations

import bisect

UPLOAD = "jmt.predict.upload"
FORWARD = "jmt.train_step.forward"
BACKWARD = "jmt.train_step.backward"
OPTIMIZER = "jmt.train_step.optimizer"


def intervals(trace, name):
    """The union of the intervals in which span ``name`` was open, on any
    thread, clipped to the window: sorted, disjoint [start, end] in ns."""
    out = []
    for s, e in sorted((max(c[0], trace._ws), min(c[1], trace._we)) for c in trace.cpu
                       if c[3] == name):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def calls(trace, name):
    """How many spans ``name`` began in the window."""
    return sum(1 for c in trace.cpu if c[3] == name and trace._ws <= c[0] < trace._we)


def device_s(trace, ivs):
    """Seconds of the device operations in the window launched inside the
    intervals ``ivs`` (``intervals``)."""
    starts = [s for s, _ in ivs]
    total = 0
    for s, t, _, _, corr in trace.gpu:
        op = trace._by_id.get(corr) if corr else None  # 0: linked to no op
        if op is None:
            continue
        i = bisect.bisect_right(starts, op[0]) - 1
        if i >= 0 and op[0] < ivs[i][1]:
            total += t - s
    return total / 1e9


def idle_s(trace, ivs):
    """Seconds of the intervals ``ivs`` in which no kernel ran (the
    trace's ``busy_intervals`` taken out)."""
    busy, j, total = trace.busy_intervals, 0, 0
    for s, e in ivs:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        at, k = s, j
        while k < len(busy) and busy[k][0] < e:
            total += max(0, busy[k][0] - at)
            at = max(at, busy[k][1])
            k += 1
        total += max(0, e - at)
    return total / 1e9


def ms_per_call(trace, name):
    """The device ms launched inside span ``name`` over the spans that
    began in the window; None without such a span."""
    n = calls(trace, name)
    if not n:
        return None
    return 1000.0 * device_s(trace, intervals(trace, name)) / n


def idle_share(trace, name):
    """The share of the window, in %, in which span ``name`` was open and no
    kernel ran; None without such a span."""
    if not calls(trace, name) or trace.window_s <= 0:
        return None
    return 100.0 * idle_s(trace, intervals(trace, name)) / trace.window_s
