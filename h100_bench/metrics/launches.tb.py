"""Device activities a step launched inside the port's ``pel.train_step``
span (``models/sparse_train.py``) on rank 0: kernels, copies and fills,
the collectives' included."""

from h100_bench import spans

UNIT = "count"


def read(run):
    return spans.launches(run, "pel.train_step")
