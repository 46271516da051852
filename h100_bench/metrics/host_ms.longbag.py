"""Host ms a batch inside the port's ``pel.forward`` span
(``models/dlrm.py`` ``DLRM.forward``): read from a traced run, so an upper
bound on the untraced host time."""

from h100_bench import spans

UNIT = "ms"


def read(run):
    return spans.host_ms(run, "pel.forward")
