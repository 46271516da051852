"""Device ms a batch of the activities launched inside the port's
``pel.lookup.small`` span: the hybrid's small set (``parallel/hybrid.py``
``_mxu_pooled_lookup``: one-hot fill, scatter, bf16 ``bmm``, sum)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup.small")
