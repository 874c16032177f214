"""upload_idle.infer: the share of the traced window in which the program's
upload span (``jmt.predict.upload``) was open and no kernel ran on the
device (the span's intervals less the trace's busy intervals), in %."""

from bench_h100 import spans


def read(run):
    if run.trace is None:
        return None
    return spans.idle_share(run.trace, spans.UPLOAD)
