"""K1's share of its HBM bound in the traced batches: the bytes of both of
the hybrid's sets, the small set's tables and the big ones alike (each
distinct kept row once, every id and mask byte once, the pooled f32 output
once), at 3.35 TB/s, over the summed time of every ``fixedl_pool_kernel``
launch, the small set's ``ROUND_BF16`` instance and the big set's."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.roofline(run, "fixedl_pool_kernel", "pool_bytes")
