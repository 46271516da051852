"""Fixed-point int32 embedding mode: the reference's numerics, bit for bit.

The counterpart of ``pim_embedding_lookup_tpu.ops.fixedpoint``.  The
reference stores tables as ``float * 1e9`` in int32, pools with wraparound
int32 adds on its devices and decodes with ``/ 1e9`` on the host
(emb_host.h:207-212, emb_dpu_lookup.c:114).  This module reproduces that
arithmetic so that tests can check results against the reference's
tolerance contract.  It is plain PyTorch, as the JAX version is XLA work:
the sums are taken in int64 and wrapped to int32 once, which gives the
int32 wraparound sum exactly (addition modulo 2**32 does not depend on the
order), on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

from .ragged import segment_ids_from_offsets

SCALE = 1e9  # emb_host.h:210


def encode(x: torch.Tensor, scale: float = SCALE) -> torch.Tensor:
    """float -> int32 fixed point (C cast semantics: truncation toward
    zero), computed in f32 as the JAX version computes it."""
    return torch.trunc(x.float() * scale).to(torch.int32)


def decode(x: torch.Tensor, scale: float = SCALE) -> torch.Tensor:
    """int32 fixed point -> float (emb_host.h:210 ``/ 1e9``), an f32
    division by a tensor (PyTorch's CUDA division by a scalar multiplies by
    its reciprocal, which may differ in the last bit)."""
    return x.float() / torch.full((), scale, dtype=torch.float32, device=x.device)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32, into [-2**31, 2**31)."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def embedding_bag_fixed_point(
    table_i32: torch.Tensor,  # [N, D] int32 encoded
    indices: torch.Tensor,  # [C]
    offsets: torch.Tensor,  # [B+1]
    *,
    batch_size: int,
    decode_output: bool = True,
) -> torch.Tensor:  # [B, D] f32 decoded (or the raw int32 sums)
    """SUM-pool in int32 with wraparound, then decode: the reference's
    device kernel's arithmetic, then its host's ``/ 1e9``.
    ``decode_output=False`` returns the raw int32 sums.  Entries at or
    past offsets[B] are padding, never read."""
    capacity = indices.shape[0]
    seg = segment_ids_from_offsets(offsets, capacity).long()
    valid = seg < batch_size
    ids = torch.where(valid, indices.long(), 0)
    rows = table_i32.index_select(0, ids).long() * valid[:, None]
    sums = torch.zeros(batch_size + 1, table_i32.shape[1], dtype=torch.int64,
                       device=table_i32.device)
    sums.index_add_(0, seg, rows)
    pooled = _wrap_int32(sums[:batch_size])
    return decode(pooled) if decode_output else pooled
