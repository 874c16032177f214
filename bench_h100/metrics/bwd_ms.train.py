"""bwd_ms.train: the device time of the kernels, copies and fills launched
inside the train step's backward span (``jmt.train_step.backward``), over the
number of those spans that began in the traced window (a step each), in
ms."""

from bench_h100 import spans


def read(run):
    if run.trace is None:
        return None
    return spans.ms_per_call(run.trace, spans.BACKWARD)
