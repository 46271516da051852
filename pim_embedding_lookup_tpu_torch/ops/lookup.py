"""Embedding-bag gather + pool in plain PyTorch: the CSR, fixed-L and
one-hot forms.

The counterpart of ``pim_embedding_lookup_tpu.ops.lookup``, whose functions
are XLA work in the JAX package (a gather plus a segment reduce, or a
one-hot matmul), so here they are ordinary PyTorch operations on any
device: ``index_select`` plus ``index_add_`` or ``scatter_reduce_``, and a
``torch.matmul`` of per-bag counts.  Results keep the table's dtype.
"""

from __future__ import annotations

import torch

from ..config import Combiner
from .ragged import bag_lengths, segment_ids_from_offsets

_NEG_INF = -3.4e38  # max-combiner identity for f32/bf16


def _combine_segments(rows, seg_ids, batch_size, combiner):
    """[C, D] rows, [C] segment ids in [0, B] (B is the padding bin) ->
    [B, D]; empty MAX bags give 0."""
    d = rows.shape[1]
    if combiner == Combiner.MAX:
        pooled = torch.full((batch_size + 1, d), _NEG_INF, dtype=rows.dtype,
                            device=rows.device)
        pooled.scatter_reduce_(0, seg_ids.long()[:, None].expand(-1, d), rows,
                               "amax")
        pooled = pooled[:batch_size]
        return torch.where(pooled <= _NEG_INF, 0.0, pooled).to(rows.dtype)
    pooled = torch.zeros((batch_size + 1, d), dtype=rows.dtype, device=rows.device)
    pooled.index_add_(0, seg_ids.long(), rows)
    return pooled[:batch_size]


def embedding_bag_csr(
    table: torch.Tensor,  # [N, D]
    indices: torch.Tensor,  # [C] int, entries >= offsets[-1] are padding
    offsets: torch.Tensor,  # [B+1] int, offsets[0] == 0
    *,
    batch_size: int,
    combiner: Combiner = Combiner.SUM,
) -> torch.Tensor:  # [B, D]
    """Pooled lookup over CSR bags.  MEAN divides by max(len, 1)."""
    combiner = Combiner(combiner)
    seg_ids = segment_ids_from_offsets(offsets, indices.shape[0])
    valid = (seg_ids < batch_size)[:, None]
    rows = table.index_select(0, torch.where(valid[:, 0], indices, 0).long())
    fill = _NEG_INF if combiner == Combiner.MAX else 0.0
    rows = torch.where(valid, rows, fill).to(table.dtype)
    pooled = _combine_segments(rows, seg_ids, batch_size, combiner)
    if combiner == Combiner.MEAN:
        lengths = bag_lengths(offsets).clamp(min=1).to(pooled.dtype)
        pooled = pooled / lengths[:, None]
    return pooled


def embedding_bag_dense(
    table: torch.Tensor,  # [N, D]
    indices: torch.Tensor,  # [B, L] int
    mask: torch.Tensor | None = None,  # [B, L] bool; None = all valid
    *,
    combiner: Combiner = Combiner.SUM,
) -> torch.Tensor:  # [B, D]
    """Fixed pooling-factor form: every bag has L entries, some masked."""
    combiner = Combiner(combiner)
    rows = table[indices.long()]  # [B, L, D]
    if mask is None:
        if combiner == Combiner.MAX:
            return rows.amax(dim=1)
        pooled = rows.sum(dim=1)
        if combiner == Combiner.MEAN:
            pooled = pooled / indices.shape[1]
        return pooled
    m = mask.bool()[..., None]
    if combiner == Combiner.MAX:
        pooled = torch.where(m, rows, _NEG_INF).to(rows.dtype).amax(dim=1)
        return torch.where(pooled <= _NEG_INF, 0.0, pooled).to(rows.dtype)
    pooled = torch.where(m, rows, 0.0).to(rows.dtype).sum(dim=1)
    if combiner == Combiner.MEAN:
        counts = mask.sum(dim=1).clamp(min=1).to(pooled.dtype)
        pooled = pooled / counts[:, None]
    return pooled


def embedding_bag_onehot(
    table: torch.Tensor,  # [N, D], N small
    indices: torch.Tensor,  # [C]
    offsets: torch.Tensor,  # [B+1]
    *,
    batch_size: int,
) -> torch.Tensor:  # [B, D]
    """SUM pooling as ``A @ table``, where A[b, n] counts the entries of bag
    b that read row n; the product is taken in f32.  Cost O(B*N*D), so it
    suits tables of a few thousand rows."""
    n = table.shape[0]
    seg_ids = segment_ids_from_offsets(offsets, indices.shape[0]).long()
    valid = seg_ids < batch_size
    # entry e counts at A[seg, idx]; padding entries land in row B, dropped
    key = seg_ids.clamp(max=batch_size) * n + torch.where(valid, indices.long(), 0)
    counts = torch.zeros((batch_size + 1) * n, dtype=torch.float32,
                         device=table.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.float32))
    a = counts.reshape(batch_size + 1, n)[:batch_size]
    return torch.matmul(a, table.float()).to(table.dtype)
