"""Model operations of the trained samples (three times the forward's)
over the window, as a share of the card's f32 peak (67 TFLOP/s)."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.mfu(run)
