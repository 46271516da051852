"""Device activities a step launched inside the port's ``pel.train_step``
span (``models/sparse_train.py``): kernels, copies and fills."""

from h100_bench import spans

UNIT = "count"


def read(run):
    return spans.launches(run, "pel.train_step")
