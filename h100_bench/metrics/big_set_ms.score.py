"""Device ms a batch of the activities launched inside the port's
``pel.lookup.big`` span: the hybrid's big set (``parallel/collection.py``
``EmbeddingCollection.lookup``: id globalization and K1)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup.big")
