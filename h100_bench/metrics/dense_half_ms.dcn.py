"""Device ms a batch of the activities launched inside the port's
``pel.forward`` span less those inside its ``pel.lookup``: the dense half,
``DLRM.apply_from_pooled`` (``models/dlrm.py``): the bottom MLP, the cross
network and the top MLP."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.forward", less="pel.lookup")
