"""Model operations of the scored samples over the window, as a share of
the card's f32 peak (67 TFLOP/s, outside the tensor cores)."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.mfu(run)
