"""K1's share of its HBM bound in the traced batches: each distinct kept
row of the big tables once, every id and mask byte once and the pooled output
once, at 3.35 TB/s, over the summed time of ``fixedl_pool_kernel``."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.roofline(run, "fixedl_pool_kernel", "pool_bytes")
