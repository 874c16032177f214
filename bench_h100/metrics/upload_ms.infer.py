"""upload_ms.infer: the device time of the copies and kernels launched inside
the program's upload span (``jmt.predict.upload``, around
``Predictor.predict``'s copy of a batch to the card), over the number of
those spans that began in the traced window, in ms."""

from bench_h100 import spans


def read(run):
    if run.trace is None:
        return None
    return spans.ms_per_call(run.trace, spans.UPLOAD)
