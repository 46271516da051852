"""Device ms a step of the activities launched inside the port's
``pel.sparse_update`` span (``parallel/hybrid.py`` ``sparse_update_hybrid``):
both sets' SGD step, on a mesh the eager update after the data axis's
gathers of each set's ids, mask and cotangents."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.sparse_update")
