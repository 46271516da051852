"""Per cent of the traced window in which rank 0's card ran nothing: one
less the union of its activities' intervals over the window."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.idle_share(run)
