"""K1's share of its HBM bound in the traced DCNv2 batches: the bytes of
both of the hybrid's sets (each distinct kept row once, the pooled f32
output once, and every id and mask byte of the dense wire's padded slots
once: 100 slots a bag in every table, 2,600 a sample for 214 ids) at
3.35 TB/s, over the summed time of every ``fixedl_pool_kernel`` launch,
the small set's ``ROUND_BF16`` instance and the big set's."""

from h100_bench import readers

UNIT = "%"


def read(run):
    return readers.roofline(run, "fixedl_pool_kernel", "pool_bytes")
