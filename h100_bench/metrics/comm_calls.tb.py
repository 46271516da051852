"""The port's collective spans (``pel.comm.model`` and ``pel.comm.data``,
``parallel/mesh.py``) a train step: the collectives on the timed path."""

from h100_bench import comm

UNIT = "count"


def read(run):
    return comm.spans_a_step(run, "pel.comm.model", "pel.comm.data")
