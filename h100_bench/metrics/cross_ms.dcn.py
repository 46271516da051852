"""Device ms a batch of the activities launched inside the port's
``pel.cross`` span: the low-rank cross network (``models/dlrm.py``
``LowRankCrossNet``), its V and W products and its residual updates."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.cross")
