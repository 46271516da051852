"""Device ms a batch of the kernels launched inside the harness's
``dense_half`` span: ``DLRM.apply_from_pooled`` (``models/dlrm.py``)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "dense_half")
