"""Sparse in-place embedding updates: each entry's step is scatter-added
straight into the fused storage, and no dense [rows, D] gradient is built.

The counterpart of ``pim_embedding_lookup_tpu.parallel.sparse_update``, on
one device or on a mesh.  Every valid entry (id, bag cotangent) becomes one
d-wide step, SGD or row-wise AdaGrad (one f32 accumulator per fused row),
added with ``index_add_``: the JAX package's XLA scatters, not a Pallas
kernel.  Storage and accumulator are updated in place, which stands in for
the JAX step's buffer donation.  The dense wire's step is
``ops.sparse_step`` (:func:`takes_sparse_step`) on one process and on a
mesh, off the routed path and COLUMN: on the card one hand-written CUDA
step over the entries in place, on the CPU these same operations.

On a mesh the entry stream is first all-gathered over the data axis in
data-row order (on the dense wire the ids, the mask and the cotangents,
one collective each), so every data replica applies the whole batch.
Then each process applies what it holds: a row shard the entries it owns,
a COLUMN shard its dim slice of every entry (row AdaGrad's mean_d(g^2)
averaged over the model axis, so that every slice adds the same value to
the replicated accumulator).  On the CPU the replicas stay bitwise equal;
on the card the sparse step's atomics add in an order of their own on
each replica, which then agree within the bound of recursive summation.
``routed=True`` instead sends (id, update) pairs to their owners through
the capacity buckets of the routed lookup, and counts what overflows.

Dropped entries (masked, CSR padding, other shards' ids) keep a valid row
id and add an exact identity there: -0.0 to a weight (w + -0.0 == w for
every w, signed zeros included), 0.0 to the non-negative accumulator.  An
out-of-range index would be a device-side assert on CUDA, and compacting
the entries out would wait for the device.
"""

from __future__ import annotations

import torch

from ..config import ShardingPolicy
from ..ops.ragged import segment_ids_from_offsets
from ..ops.sparse_step import (
    OPTIMIZERS,
    StepPlan,
    apply_entries,
    entry_updates,
    make_plan,
    sparse_step,
)
from .collection import (
    EmbeddingCollection,
    _bucket_slots,
    _owner_local,
    _rowish,
    _slice_entries,
    routed_bucket_k,
)
from .mesh import DATA_AXIS, MODEL_AXIS


def _entry_updates_csr(g_idx, offsets, g_pooled):
    """CSR form of entry_updates: bag membership from the offsets.  Each
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


def _owned_entries(coll, ids, valid):
    """(local row ids, kept) of a flat entry stream on this process's
    storage: a row shard keeps the entries it owns, other policies every
    valid entry whose id lies in the storage."""
    lay = coll.layout
    if _rowish(lay.policy):
        owner, local = _owner_local(ids, lay.rows_per_shard, lay.num_shards,
                                    lay.policy == ShardingPolicy.ROW_HASH)
        return local, (owner == coll.shard) & (local < lay.rows_per_shard) & valid
    return ids, valid & (ids >= 0) & (ids < lay.total_rows)


def _routed_apply_entries(coll, emb, acc, ids, updates, valid, *, cf, lr, eps,
                          use_adagrad):
    """All-to-all routed optimizer step (ROW, ROW_HASH, TABLE_WISE) over a
    flat entry stream: model peer mi takes the mi-th E/M slice, sends
    (owner-local id, update) pairs to their owners through the capacity
    buckets, and applies the ~cf*E/M pairs it receives.  Returns the count
    of dropped updates over the model axis, [1] int32."""
    lay, mesh = coll.layout, coll.mesh
    m, mi, rps = mesh.model, mesh.index(MODEL_AXIS), lay.rows_per_shard
    em = -(-ids.shape[0] // m)
    gs, vs, us = _slice_entries(mi, m, em, ids, valid, updates)
    owner, local = _owner_local(gs, rps, m, lay.policy == ShardingPolicy.ROW_HASH)
    k = routed_bucket_k(em, cf, m)
    slot, ok = _bucket_slots(owner.clamp(0, m - 1).long(), vs, m, k)
    dropped = mesh.psum((vs & ~ok).sum(dtype=torch.int32).reshape(1), MODEL_AXIS)

    send_ids = torch.full((m * k + 1,), rps, dtype=gs.dtype, device=gs.device)
    send_ids[slot] = torch.where(ok, local, rps).to(gs.dtype)
    send_upd = torch.zeros(m * k + 1, us.shape[-1], dtype=us.dtype, device=us.device)
    send_upd[slot] = torch.where(ok[:, None], us, 0.0)
    recv_ids = mesh.all_to_all(send_ids[: m * k])
    recv_upd = mesh.all_to_all(send_upd[: m * k])
    keep = (recv_ids >= 0) & (recv_ids < rps)
    apply_entries(emb, acc, recv_ids, recv_upd, keep, lr=lr, eps=eps,
                  use_adagrad=use_adagrad)
    return dropped


def _apply(coll, fused, acc, ids, updates, valid, *, lr, eps, optimizer, routed,
           capacity_factor):
    """Apply a flat entry stream on this process; returns the drop count,
    0-d int32 (0 off the routed path)."""
    use_adagrad = optimizer == "row_adagrad"
    if routed:
        return _routed_apply_entries(
            coll, fused, acc, ids, updates, valid, cf=coll._resolve_cf(capacity_factor),
            lr=lr, eps=eps, use_adagrad=use_adagrad).reshape(())
    mean_sq = None
    mesh = coll.mesh
    if coll.layout.policy == ShardingPolicy.COLUMN and use_adagrad:
        mean_sq = lambda sq: mesh.psum(sq, MODEL_AXIS) / mesh.model  # noqa: E731
    local, keep = _owned_entries(coll, ids, valid)
    apply_entries(fused, acc, local, updates, keep, lr=lr, eps=eps,
                  use_adagrad=use_adagrad, mean_sq=mean_sq)
    return torch.zeros((), dtype=torch.int32, device=acc.device)


def _check_supported(coll, optimizer, routed, name):
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown embedding optimizer {optimizer!r}; "
                         f"expected one of {OPTIMIZERS}")
    if routed and not _rowish(coll.layout.policy):
        raise ValueError(f"routed {name} needs ROW/ROW_HASH/TABLE_WISE")
    coll._require_mesh(name)


def takes_sparse_step(coll: EmbeddingCollection, routed: bool = False) -> bool:
    """Whether the dense-wire step of ``coll`` is ``ops.sparse_step``: not
    routed, and a layout other than COLUMN, on one process or on a mesh.
    The routed all-to-all and COLUMN's dim slices keep the eager step."""
    return not routed and coll.layout.policy != ShardingPolicy.COLUMN


def held_rows(coll: EmbeddingCollection) -> tuple[int, tuple[int, int, bool] | None]:
    """(fused rows this process holds, its row shard): under a row policy
    over more than one shard a shard's rows and (shards, this shard,
    strided), the shard of ``ops.sparse_step``'s plan; else every row and
    None (one shard holds every row)."""
    lay = coll.layout
    if not _rowish(lay.policy) or lay.num_shards == 1:
        return lay.total_rows, None
    return lay.rows_per_shard, (lay.num_shards, coll.shard,
                                lay.policy == ShardingPolicy.ROW_HASH)


def step_plan(coll: EmbeddingCollection) -> StepPlan:
    """The collection's plan for ``ops.sparse_step`` (every table in the
    big set), built at the first step and kept."""
    if coll._step_plan is None:
        lay = coll.layout
        rows, row_shard = held_rows(coll)
        object.__setattr__(coll, "_step_plan", make_plan(
            lay.dim, coll.device, big=(tuple(range(lay.num_tables)), lay.row_offsets, rows),
            row_shard=row_shard))
    return coll._step_plan


def whole_batch(mesh, indices, mask, g_pooled):
    """The dense wire's (int32 ids, bool mask, f32 cotangents) as
    ``ops.sparse_step`` takes them, contiguous: on a mesh the whole batch,
    each all-gathered once over the data axis in data-row order (the mask
    as bytes), else the caller's own."""
    indices = indices.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    g_pooled = g_pooled.float().contiguous()
    if mesh is None:
        return indices, mask, g_pooled
    return (mesh.all_gather(indices, DATA_AXIS, 1),
            mesh.all_gather(mask.view(torch.uint8), DATA_AXIS, 1).view(torch.bool),
            mesh.all_gather(g_pooled, DATA_AXIS, 0))


def sparse_update(
    coll: EmbeddingCollection,
    fused: torch.Tensor,  # this process's storage, updated in place
    acc: torch.Tensor,  # its f32 row-AdaGrad accumulator (init_accumulator), in place
    indices: torch.Tensor,  # [T, B*L] local (per-table) ids, this data row's slice
    mask: torch.Tensor,  # [T, B*L] bool
    g_pooled: torch.Tensor,  # [B, T, D] d(loss)/d(pooled), this data row's
    *,
    lr: float,
    optimizer: str = "sgd",  # "sgd" | "row_adagrad"
    eps: float = 1e-8,
    routed: bool = False,
    capacity_factor: float | None = None,
    return_stats: bool = False,
):
    """Scatter-apply the embedding optimizer step.  Returns (fused, acc),
    or (fused, acc, dropped) with ``return_stats=True``.  ``routed=True``
    (row policies) routes (id, update) pairs to their owners;
    ``capacity_factor=None`` is the collection's safe factor, at which
    nothing drops.  Off the routed path and COLUMN the step is
    ``ops.sparse_step`` (:func:`takes_sparse_step`)."""
    _check_supported(coll, optimizer, routed, "sparse_update")
    if takes_sparse_step(coll, routed):
        sparse_step(step_plan(coll), None, (fused, acc),
                    *whole_batch(coll.mesh, indices, mask, g_pooled), lr=lr,
                    optimizer=optimizer, eps=eps)
        if return_stats:
            return fused, acc, torch.zeros((), dtype=torch.int32, device=acc.device)
        return fused, acc
    pooling = indices.shape[1] // g_pooled.shape[0]
    g_idx = coll.globalize(indices.to(torch.int32))
    mask = mask.to(torch.bool)
    g_pooled = g_pooled.float()
    mesh = coll.mesh
    if mesh is not None:  # the whole batch, in data-row order
        g_idx = mesh.all_gather(g_idx, DATA_AXIS, 1)
        mask = mesh.all_gather(mask, DATA_AXIS, 1)
        g_pooled = mesh.all_gather(g_pooled, DATA_AXIS, 0)
    if coll.layout.policy == ShardingPolicy.COLUMN:
        w = coll.layout.dim // coll.layout.num_shards
        g_pooled = g_pooled[..., coll.shard * w:(coll.shard + 1) * w]
    ids, updates, valid = entry_updates(g_idx, mask, g_pooled, pooling)
    dropped = _apply(coll, fused, acc, ids, updates, valid, lr=lr, eps=eps,
                     optimizer=optimizer, routed=routed, capacity_factor=capacity_factor)
    if return_stats:
        return fused, acc, dropped
    return fused, acc


def sparse_update_csr(
    coll: EmbeddingCollection,
    fused: torch.Tensor,
    acc: torch.Tensor,
    indices: torch.Tensor,  # [T, C] local ids, padded (this process's window if data_sharded)
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
    ``data_sharded`` follows lookup_csr: each process holds its own window,
    and the entry streams are all-gathered over the data axis; otherwise
    every process holds the whole batch.  COLUMN is refused, as in the JAX
    package."""
    _check_supported(coll, optimizer, routed, "sparse_update_csr")
    if coll.layout.policy == ShardingPolicy.COLUMN:
        raise ValueError("sparse_update_csr: COLUMN sharding not supported (use the dense "
                         "form or a rowish policy)")
    g_idx = coll.globalize(indices.to(torch.int32))
    ids, updates, valid = _entry_updates_csr(g_idx, offsets, g_pooled.float())
    if data_sharded and coll.mesh is not None:
        ids = coll.mesh.all_gather(ids, DATA_AXIS, 0)
        updates = coll.mesh.all_gather(updates, DATA_AXIS, 0)
        valid = coll.mesh.all_gather(valid, DATA_AXIS, 0)
    dropped = _apply(coll, fused, acc, ids, updates, valid, lr=lr, eps=eps,
                     optimizer=optimizer, routed=routed, capacity_factor=capacity_factor)
    if return_stats:
        return fused, acc, dropped
    return fused, acc


def init_accumulator(coll: EmbeddingCollection) -> torch.Tensor:
    """Row-wise AdaGrad accumulator: 1-D f32 zeros, one per fused row even
    when the storage is lane-packed; [rows_per_shard] on a row shard, the
    whole [total_rows] replicated otherwise."""
    return torch.zeros(held_rows(coll)[0], dtype=torch.float32, device=coll.device)
