"""Model operations of the scored DCNv2 samples over the window, as a
share of the card's f32 peak (67 TFLOP/s, outside the tensor cores): the
MLPs' and the cross network's multiply-adds twice and the pooling's adds
(``dense/dcn.py`` ``flops_per_sample``)."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.mfu(run)
