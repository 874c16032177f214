"""Named spans of the port's own work, seen by ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records on the calling thread, and one shared null context otherwise: an
idle ``record_function`` costs tens of microseconds to enter and leave, the
flag check a fraction of one. There is no other switch: a profiler that
records (``torch.profiler.profile``) turns the spans on. They land in
Kineto's event list beside the kernels and copies, on one clock, and each
device event links to the CPU op that launched it, so a reader of the trace
can put every kernel, copy and idle gap down to the span that was open.

The names begin with ``jmt.``, never with ``jittor_mlp_tpu_torch::``, the
prefix of the port's kernel ops, which trace readers count as launches.

- ``UPLOAD``: ``Predictor.predict``'s copy of the request's images to the
  device;
- ``FORWARD``, ``BACKWARD``, ``OPTIMIZER``: the train step's loss (the
  casts at its boundary, the forward and the loss), its ``backward()`` and
  its ``optimizer.step()``.
"""

from __future__ import annotations

import contextlib

import torch

UPLOAD = "jmt.predict.upload"
FORWARD = "jmt.train_step.forward"
BACKWARD = "jmt.train_step.backward"
OPTIMIZER = "jmt.train_step.optimizer"
NAMES = (UPLOAD, FORWARD, BACKWARD, OPTIMIZER)

_OFF = contextlib.nullcontext()


def span(name):
    """A context manager that records span ``name`` while a profiler
    records on this thread; otherwise the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
