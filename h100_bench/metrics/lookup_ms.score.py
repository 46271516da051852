"""Device ms a batch of the activities launched inside the port's
``pel.lookup`` span: the embedding collection, both sets
(``parallel/hybrid.py`` ``HybridEmbeddingCollection.lookup``)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup")
