"""Device activities a batch launched inside the port's ``pel.forward``
span (``models/dlrm.py`` ``DLRM.forward``) in the DCNv2 cell: kernels,
copies and fills."""

from h100_bench import spans

UNIT = "count"


def read(run):
    return spans.launches(run, "pel.forward")
