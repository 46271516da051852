"""Model operations of the samples rank 0 trained (three times the
forward's) over its window, as a share of one card's f32 peak (67 TFLOP/s)."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.mfu(run)
