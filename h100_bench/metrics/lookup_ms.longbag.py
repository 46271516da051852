"""Device ms a batch of the kernels launched inside the harness's ``lookup``
span: the embedding collection (``parallel/hybrid.py``, ``parallel/collection.py``)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "lookup")
