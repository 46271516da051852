"""Device ms a step of the activities launched inside the port's
``pel.lookup`` span: the train step's forward lookup of both sets
(``parallel/hybrid.py`` ``HybridEmbeddingCollection.lookup``), on a mesh
the big set's masked K1 over its row shard and its psum over the model
axis."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup")
