"""Structured training and serving metrics (counterpart of
``jittor_mlp_tpu/utils/metrics.py``; the same JSONL, byte for byte, for the
same logs).

``MetricsLogger`` appends one JSON object per step to a ``.jsonl`` file
(whole-line appends, safe across restarts); ``read_metrics`` loads a file
back into column lists. ``log`` takes Python numbers, numpy scalars or 0-d
tensors; a tensor on the card is read once, at log time, so call it outside
the step's hot path.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, path, flush_every=1, extra=None):
        self.path = path
        self.flush_every = flush_every
        self._buf = []
        self._t0 = time.time()
        self._count = 0
        if extra:
            self._append([{"event": "meta", **extra}])

    def _append(self, records):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")

    def log(self, step, **scalars):
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._buf.append(rec)
        self._count += 1
        if len(self._buf) >= self.flush_every:
            self.flush()
        return rec

    def flush(self):
        if self._buf:
            self._append(self._buf)
            self._buf.clear()


def read_metrics(path):
    """Load a metrics .jsonl into {key: list} columns (meta events skipped)."""
    cols = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == "meta":
                continue
            for k, v in rec.items():
                cols.setdefault(k, []).append(v)
    return cols
