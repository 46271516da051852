"""Device ms a step of the activities launched inside the port's
``pel.interact.backward`` span (``models/dlrm.py`` ``_TrilPairs``): the
backward of ``interact_dot``'s lower-triangle gather, a fill of the
[B, 1+T, 1+T] gradient and a plain write of the pairs' cotangent into it.
A program without the span gives None."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.interact.backward")
