"""Device ms a step of the activities launched inside the port's
``pel.lookup`` span: the train step's forward lookup, both sets
(``parallel/hybrid.py`` ``HybridEmbeddingCollection.lookup``)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup")
