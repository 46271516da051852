"""Host ms a step inside the port's ``pel.train_step`` span
(``models/sparse_train.py``) on rank 0: read from a traced run, so an upper
bound on the untraced host time."""

from h100_bench import spans

UNIT = "ms"


def read(run):
    return spans.host_ms(run, "pel.train_step")
