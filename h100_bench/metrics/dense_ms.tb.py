"""Device ms a step of the activities launched inside the port's
``pel.train.dense`` span (``models/sparse_train.py``): the dense half's
forward, the loss, its backward, the all-reduce of the MLPs' gradients and
of the loss over the data axis, and the MLPs' optimizer step."""

from h100_bench import readers

UNIT = "ms"


def read(run):
    return readers.span_device_ms(run, "pel.train.dense")
