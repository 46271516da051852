"""Device ms a batch of the activities launched inside the port's
``pel.lookup`` span in the DCNv2 cell: the embedding collection, both sets
(``parallel/hybrid.py`` ``HybridEmbeddingCollection.lookup``), over bags of
a length a table padded to the longest."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup")
