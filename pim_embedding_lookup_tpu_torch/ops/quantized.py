"""Row-wise int8 quantized embedding storage.

The counterpart of ``pim_embedding_lookup_tpu.ops.quantized``.  Storage is
int8 with a per-row f32 scale (1-D [N]); accumulation happens in f32 after
dequantization.  On a CUDA tensor ``embedding_bag_quantized`` is the int8
instance of the CSR gather+pool kernel (K2) at one table, with the per-row
scale loaded beside each row; on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from .csr_pool import embedding_bag_csr_packed


def quantize_rowwise(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] f32 -> (int8 [N, D], scale f32 [N]) with symmetric per-row
    scaling (scale = absmax/127; zero rows get scale 1 to avoid 0/0).
    Rounds half to even, as ``jnp.round`` does; divides tensor by tensor
    (PyTorch's CUDA division by a scalar multiplies by its reciprocal)."""
    table = table.float()
    absmax = table.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), 1.0)
    q = torch.clamp(torch.round(table / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q_rows: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 rows [C, D] + per-row scales [C] -> f32 rows."""
    return q_rows.float() * scales[:, None]


def embedding_bag_quantized(
    q_table: torch.Tensor,  # [N, D] int8
    scales: torch.Tensor,  # [N] f32
    indices: torch.Tensor,  # [C]
    offsets: torch.Tensor,  # [B+1]
    *,
    batch_size: int,
) -> torch.Tensor:  # [B, D] f32
    """SUM-pooled lookup over int8 storage: each bag sums its rows'
    codes times their scales in f32.  Entries at or past offsets[B] are
    padding, never read."""
    return embedding_bag_csr_packed(
        q_table.contiguous(), q_table.shape[1], indices.to(torch.int32).contiguous(),
        offsets.to(torch.int32).contiguous(), batch_size=batch_size,
        scale=scales.float().contiguous())
