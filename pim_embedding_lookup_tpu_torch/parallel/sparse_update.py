"""Sparse in-place embedding updates: each entry's step is scatter-added
straight into the fused storage, and no dense [rows, D] gradient is built.

The counterpart of ``pim_embedding_lookup_tpu.parallel.sparse_update`` on
one device (REPLICATE; routed updates and the other policies need the
multi-device port).  Every valid entry (id, bag cotangent) becomes one
d-wide step, SGD or row-wise AdaGrad (one f32 accumulator per fused row),
added with ``index_add_``: the JAX package's XLA scatters, not a Pallas
kernel.  Storage and accumulator are updated in place, which stands in for
the JAX step's buffer donation.

Dropped entries (masked, CSR padding, ids outside the storage) keep a valid
row id and add an exact identity there: -0.0 to a weight (w + -0.0 == w for
every w, signed zeros included), 0.0 to the non-negative accumulator.  An
out-of-range index would be a device-side assert on CUDA, and compacting the
entries out would wait for the device.
"""

from __future__ import annotations

import torch

from ..config import ShardingPolicy
from ..ops.ragged import segment_ids_from_offsets
from .collection import EmbeddingCollection

OPTIMIZERS = ("sgd", "row_adagrad")


def _entry_updates(g_idx, mask, g_pooled, pooling):
    """Flatten [T, B*L] entries -> (ids [T*C], updates [T*C, D], valid
    [T*C]).  Each kept entry (t, b, l) receives its bag's full cotangent
    g_pooled[b, t] (the sum-pool backward); masked entries get zeros."""
    t, c = g_idx.shape
    b = c // pooling
    d = g_pooled.shape[-1]
    g_e = g_pooled.transpose(0, 1)[:, :, None, :].expand(t, b, pooling, d).reshape(t, c, d)
    g_e = g_e * mask[..., None].to(g_e.dtype)
    return g_idx.reshape(-1), g_e.reshape(t * c, d), mask.reshape(-1)


def _entry_updates_csr(g_idx, offsets, g_pooled):
    """CSR form of _entry_updates: bag membership from the offsets.  Each
    valid entry gathers its bag's cotangent row; padding (position at or
    past offsets[t, B]) gets a zero update and valid=False.

    g_idx [T, C]; offsets [T, B+1]; g_pooled [B, T, D]."""
    t, c = g_idx.shape
    b, _, d = g_pooled.shape
    seg = segment_ids_from_offsets(offsets, c).long()  # [T, C]; padding -> B
    valid = seg < b
    g_t = g_pooled.transpose(0, 1)  # [T, B, D]
    g_e = torch.gather(g_t, 1, seg.clamp(max=max(b - 1, 0))[..., None].expand(t, c, d))
    g_e = g_e * valid[..., None].to(g_e.dtype)
    return g_idx.reshape(-1), g_e.reshape(t * c, d), valid.reshape(-1)


def _scatter_step(emb, local, step, keep):
    """Add per-entry steps [C, D] at fused row ids ``local`` in the
    storage's dtype.  Lane-packed [S, 128] storage has the bytes of
    [rows, D], so one view serves both layouts; dropped entries add -0.0
    at row 0."""
    d = step.shape[-1]
    step = torch.where(keep[:, None], step, -0.0).to(emb.dtype)
    emb.view(-1, d).index_add_(0, torch.where(keep, local, 0), step)
    return emb


def _apply_entries(emb, acc, ids, updates, valid, *, lr, eps, use_adagrad):
    """Scatter step over a flat entry stream (ids [E], updates [E, D], valid
    [E]), in place.  Row AdaGrad adds every entry's mean_d(g^2) into ``acc``
    before any entry reads it, then steps each entry by
    -lr * rsqrt(acc[row] + eps) * g_e."""
    rows = acc.shape[0]
    local = ids.long()
    keep = valid & (local >= 0) & (local < rows)
    if use_adagrad:
        sq = (updates * updates).mean(dim=-1)  # [E]
        safe = torch.where(keep, local, 0)
        acc.index_add_(0, safe, torch.where(keep, sq, 0.0))
        scale = lr * torch.rsqrt(acc[safe] + eps)  # [E]
        _scatter_step(emb, local, -scale[:, None] * updates, keep)
    else:
        _scatter_step(emb, local, -lr * updates, keep)
    return emb, acc


def _check_supported(coll, optimizer, routed, name):
    if routed:
        raise NotImplementedError(
            f"routed {name} needs the multi-device port (ROADMAP.md)")
    if coll.layout.policy != ShardingPolicy.REPLICATE:
        raise NotImplementedError(
            f"{name} for policy {coll.layout.policy.value}: only REPLICATE "
            "is ported (the other policies are listed in ROADMAP.md)")
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown embedding optimizer {optimizer!r}; "
                         f"expected one of {OPTIMIZERS}")


def sparse_update(
    coll: EmbeddingCollection,
    fused: torch.Tensor,  # fused storage, updated in place
    acc: torch.Tensor,  # [total_rows] f32 row-AdaGrad accumulator, in place
    indices: torch.Tensor,  # [T, B*L] local (per-table) ids
    mask: torch.Tensor,  # [T, B*L] bool
    g_pooled: torch.Tensor,  # [B, T, D] d(loss)/d(pooled)
    *,
    lr: float,
    optimizer: str = "sgd",  # "sgd" | "row_adagrad"
    eps: float = 1e-8,
    routed: bool = False,
    capacity_factor: float | None = None,
    return_stats: bool = False,
):
    """Scatter-apply the embedding optimizer step.  Returns (fused, acc),
    or (fused, acc, dropped) with ``return_stats=True``: the broadcast
    path drops nothing, so ``dropped`` is 0.  ``routed`` and
    ``capacity_factor`` belong to the multi-device path."""
    del capacity_factor  # only the routed path reads it
    _check_supported(coll, optimizer, routed, "sparse_update")
    pooling = indices.shape[1] // g_pooled.shape[0]
    g_idx = coll.globalize(indices.to(torch.int32))
    ids, updates, valid = _entry_updates(g_idx, mask.to(torch.bool), g_pooled.float(),
                                         pooling)
    fused, acc = _apply_entries(fused, acc, ids, updates, valid, lr=lr, eps=eps,
                                use_adagrad=optimizer == "row_adagrad")
    if return_stats:
        return fused, acc, torch.zeros((), dtype=torch.int32, device=acc.device)
    return fused, acc


def sparse_update_csr(
    coll: EmbeddingCollection,
    fused: torch.Tensor,
    acc: torch.Tensor,
    indices: torch.Tensor,  # [T, C] local ids, padded
    offsets: torch.Tensor,  # [T, B+1] bag offsets
    g_pooled: torch.Tensor,  # [B, T, D] d(loss)/d(pooled SUM)
    *,
    lr: float,
    optimizer: str = "sgd",
    eps: float = 1e-8,
    routed: bool = False,
    data_sharded: bool = False,
    capacity_factor: float | None = None,
    return_stats: bool = False,
):
    """CSR (ragged-bag) form of ``sparse_update``: the backward of
    ``lookup_csr`` with SUM pooling.  Padding ids may hold anything.
    ``data_sharded`` is the same as False on one device."""
    del capacity_factor, data_sharded
    _check_supported(coll, optimizer, routed, "sparse_update_csr")
    g_idx = coll.globalize(indices.to(torch.int32))
    ids, updates, valid = _entry_updates_csr(g_idx, offsets, g_pooled.float())
    fused, acc = _apply_entries(fused, acc, ids, updates, valid, lr=lr, eps=eps,
                                use_adagrad=optimizer == "row_adagrad")
    if return_stats:
        return fused, acc, torch.zeros((), dtype=torch.int32, device=acc.device)
    return fused, acc


def init_accumulator(coll: EmbeddingCollection) -> torch.Tensor:
    """Row-wise AdaGrad accumulator: 1-D [total_rows] f32 zeros, one per
    fused row even when the storage is lane-packed."""
    return torch.zeros(coll.layout.total_rows, dtype=torch.float32, device=coll.device)
