"""Device ms a batch of the activities launched inside the port's
``pel.lookup.small`` span: the hybrid's small set (``parallel/hybrid.py``
``_small_pooled_lookup``: its ids globalized, then K1 over its f32 rows,
each rounded to bf16 as it is added)."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.lookup.small")
