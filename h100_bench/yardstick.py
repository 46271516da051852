"""What the numbers are measured against: the card's peaks, the model's
operation count, the pool kernel's bytes, and the quartile spread.

The byte model is ``chip_smoke.py``'s: a pool kernel must read each
distinct kept row once, every id (int32) and mask byte once, and write its
f32 output once.  Operations count 2 per multiply-add of the dense half
(each family's ``flops_per_sample`` in ``dense/``), and one add per pooled
entry past a bag's first.
"""

from __future__ import annotations

import statistics

import torch

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,  # outside the tensor cores: the MLPs run in full f32
}


def distinct_rows(ids: torch.Tensor, keep: torch.Tensor) -> int:
    """The distinct rows among the kept entries of ``ids`` [T, C], keyed by
    table so that local ids of two tables stay apart."""
    keyed = ids.long() + (torch.arange(ids.shape[0], device=ids.device)[:, None] << 32)
    return int(torch.unique(keyed[keep]).numel())


def pool_bytes(ids: torch.Tensor, keep: torch.Tensor, dim: int, itemsize: int = 4) -> int:
    """Bytes a pool kernel must read for one batch of bags of ``ids``."""
    return distinct_rows(ids, keep) * dim * itemsize + ids.numel() * 5


def pool_out_bytes(tables: int, batch_size: int, dim: int) -> int:
    """Bytes of a pool kernel's f32 output."""
    return tables * batch_size * dim * 4


def macs(sizes) -> int:
    """Multiply-adds of one sample through linear layers of ``sizes``."""
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def pooling_adds(cfg: dict, lengths) -> int:
    """Adds of one sample's pooling: one a pooled entry past a bag's first,
    over bags of ``lengths`` (one a table)."""
    return sum(n - 1 for n in lengths) * cfg["dim"]


def spread(values) -> float:
    """Interquartile distance over the median, by ``statistics.quantiles``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
