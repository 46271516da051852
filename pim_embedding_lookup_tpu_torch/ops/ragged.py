"""Ragged (CSR) bags: a flat ``indices`` buffer of fixed capacity plus
per-bag ``offsets``, the reference's own wire (``lookup(uint32_t **indices,
uint32_t **offsets, ...)``, emb_host.h:234).

The counterpart of ``pim_embedding_lookup_tpu.ops.ragged``.  Bag b owns
entries ``[offsets[b], offsets[b+1])``; entries at or past ``offsets[B]`` are
padding and contribute nothing.  The host helpers work on numpy arrays and
are copies of the JAX package's; ``segment_ids_from_offsets`` and the small
tensor helpers work on torch tensors on any device.

The second half is the length-bucketed CSR form: ragged bags re-wired on the
host into a few fixed-L dense dispatches plus a residual CSR tail
(``parallel/bucketed.py`` runs them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..utils import native


def segment_ids_from_offsets(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """Map flat entry position -> owning bag id, int32.

    ``offsets`` is [..., B+1] with offsets[..., 0] == 0; the result is
    [..., capacity] with seg[p] = #{b in 1..B : offsets[b] <= p}.  Positions
    at or past offsets[B] (padding) map to B.  Empty bags make equal
    boundaries, whose marks add up, so the ids still jump past them;
    boundaries equal to the capacity fall out of range and drop.  Nothing
    here waits for the device."""
    ends = offsets[..., 1:].long().clamp(min=0, max=capacity)  # capacity: dropped
    marks = torch.zeros(*offsets.shape[:-1], capacity + 1, dtype=torch.int32,
                        device=offsets.device)
    marks.scatter_add_(-1, ends, torch.ones_like(ends, dtype=torch.int32))
    return torch.cumsum(marks[..., :capacity], dim=-1, dtype=torch.int32)


def pack_bags(
    bags: Sequence[Sequence[int]], capacity: int, pad_index: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: list of bags -> (indices[capacity], offsets[B+1]) int32."""
    flat = [i for bag in bags for i in bag]
    if len(flat) > capacity:
        raise ValueError(f"{len(flat)} indices exceed capacity {capacity}")
    indices = np.full((capacity,), pad_index, dtype=np.int32)
    indices[: len(flat)] = np.asarray(flat, dtype=np.int32)
    offsets = np.zeros((len(bags) + 1,), dtype=np.int32)
    np.cumsum([len(b) for b in bags], out=offsets[1:])
    return indices, offsets


def dense_to_csr(indices_2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, L] fixed-pooling indices -> CSR (flat indices, offsets)."""
    b, l = indices_2d.shape
    offsets = torch.arange(b + 1, dtype=torch.int32, device=indices_2d.device) * l
    return indices_2d.reshape(-1), offsets


def csr_to_dense(
    indices: torch.Tensor, offsets: torch.Tensor, max_len: int, pad_index: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR -> ([B, max_len] indices, [B, max_len] validity mask).  Bags
    longer than max_len are truncated."""
    lane = torch.arange(max_len, dtype=offsets.dtype, device=offsets.device)
    pos = offsets[:-1, None] + lane[None, :]
    mask = pos < offsets[1:, None]
    gathered = indices[pos.clamp(max=indices.shape[0] - 1).long()]
    return torch.where(mask, gathered, pad_index), mask


def bag_lengths(offsets: torch.Tensor) -> torch.Tensor:
    return offsets[..., 1:] - offsets[..., :-1]


def shard_csr(
    bags_per_table: Sequence[Sequence[Sequence[int]]],
    num_shards: int,
    capacity_per_shard: int,
    pad_index: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Host builder for the data-sharded CSR wire form.

    ``bags_per_table``: [T][B] list of bags; num_shards must divide B.
    Returns (indices [T, Nd*Cd], offsets [T, Nd*(Bd+1)]): data shard d owns
    bags [d*Bd, (d+1)*Bd), packed into its own Cd-entry window, with offsets
    relative to that window.  With one shard this is plain [T, C], [T, B+1].
    """
    t = len(bags_per_table)
    b = len(bags_per_table[0])
    if b % num_shards:
        raise ValueError(f"batch {b} not divisible by {num_shards} shards")
    bd = b // num_shards
    indices = np.full((t, num_shards * capacity_per_shard), pad_index, np.int32)
    offsets = np.zeros((t, num_shards * (bd + 1)), np.int32)
    for ti, bags in enumerate(bags_per_table):
        for d in range(num_shards):
            local = bags[d * bd : (d + 1) * bd]
            idx, off = pack_bags(local, capacity_per_shard, pad_index)
            indices[ti, d * capacity_per_shard : (d + 1) * capacity_per_shard] = idx
            offsets[ti, d * (bd + 1) : (d + 1) * (bd + 1)] = off
    return indices, offsets


# -- length-bucketed CSR (host side) -------------------------------------------


@dataclasses.dataclass(frozen=True)
class LengthBucketPlan:
    """Static shape plan for bucketed CSR dispatch.

    Bucketing is per batch element: slot b goes by its longest bag across
    tables, so all tables share one position array and the merge moves B
    rows of [T*D].  ``bucket_ls``: ascending fixed pooling widths.
    ``capacities``: slots per bucket, rounded up to ``round_to``.
    ``tail_bags``/``tail_entries``: the residual CSR's bag capacity and
    per-table entry capacity (bags longer than bucket_ls[-1], or spilled
    past full buckets).
    """

    batch: int
    bucket_ls: tuple[int, ...]
    capacities: tuple[int, ...]
    tail_bags: int
    tail_entries: int


@dataclasses.dataclass(frozen=True)
class BucketedCSR:
    """One batch packed under a LengthBucketPlan (numpy arrays).

    Per bucket k: idx/mask [T, Bk*Lk] and pos [Bk] int32 (``batch`` marks an
    unused slot), shared across tables.  Tail: per-table CSR (idx
    [T, tail_entries], off [T, tail_bags+1]) and pos [tail_bags].
    ``identity``: one bucket, no tail, slot j holds batch element j, so the
    merge is a slice.
    """

    plan: LengthBucketPlan
    idx: tuple[np.ndarray, ...]
    mask: tuple[np.ndarray, ...]
    pos: tuple[np.ndarray, ...]
    tail_idx: np.ndarray | None
    tail_off: np.ndarray | None
    tail_pos: np.ndarray | None
    identity: bool


def plan_length_buckets(
    offsets: np.ndarray,  # [T, B+1] (a representative batch)
    bucket_ls: Sequence[int] = (1, 2, 4, 8),
    slack: float = 1.3,
    round_to: int = 8,
) -> LengthBucketPlan:
    """Static bucket capacities from a representative batch: each bucket's
    batch-element count times ``slack``, rounded up to ``round_to``.
    All-empty batch elements belong to no bucket (they pool to zero)."""
    offsets = np.asarray(offsets)
    lens = offsets[:, 1:] - offsets[:, :-1]  # [T, B]
    blen = lens.max(axis=0)  # [B] longest bag of each batch element
    b = blen.shape[0]
    ls = tuple(sorted(int(l) for l in bucket_ls))
    if not ls or ls[0] < 1:
        raise ValueError(f"bucket_ls must be positive: {bucket_ls}")

    def rounded(n):
        return -(-int(np.ceil(n)) // round_to) * round_to

    caps = []
    prev = 0
    for l in ls:
        count = int(((blen > prev) & (blen <= l)).sum())
        caps.append(rounded(count * slack) if count else 0)
        prev = l
    tail_sel = blen > ls[-1]
    tail_bags = int(tail_sel.sum())
    tail_entries = int((lens[:, tail_sel].sum(axis=1)).max()) if tail_bags else 0
    if tail_bags:
        tail_bags = rounded(tail_bags * slack)
        tail_entries = int(np.ceil(tail_entries * slack))
    return LengthBucketPlan(
        batch=b,
        bucket_ls=ls,
        capacities=tuple(caps),
        tail_bags=tail_bags,
        tail_entries=tail_entries,
    )


def pack_length_buckets(
    indices: np.ndarray,  # [T, C] flat per-table ids
    offsets: np.ndarray,  # [T, B+1]
    plan: LengthBucketPlan,
    pad_index: int = 0,
    impl: str = "auto",  # auto | native | numpy
) -> BucketedCSR:
    """Pack one batch's CSR bags into the plan's fixed shapes.

    A batch element goes to the first bucket with L >= its longest bag that
    has a free slot; full buckets spill to the next larger bucket, then to
    the tail, which also takes elements longer than bucket_ls[-1].  Raises
    ValueError when the tail overflows (re-plan with more slack, or use
    lookup_csr for that batch).  ``impl``: "native" is the threaded C++
    packer of ``native/`` (``utils.native.pack_buckets``) and raises
    RuntimeError where its library is not built; "numpy" the packer below;
    "auto" the native one where the library loads, else numpy.  Both give
    the same bytes."""
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown packer {impl!r}")
    offsets = np.asarray(offsets)
    b = offsets.shape[1] - 1
    if b != plan.batch:  # before either packer: the native one would mis-pack
        raise ValueError(f"batch {b} != plan batch {plan.batch}")
    if impl != "numpy":
        packed = native.pack_buckets(
            indices, offsets, bucket_ls=plan.bucket_ls, capacities=plan.capacities,
            tail_bags=plan.tail_bags, tail_entries=plan.tail_entries,
            pad_index=pad_index)
        if packed is not None:
            idx_t, mask_t, pos_t, tail_idx, tail_off, tail_pos = packed
            tail_used = int((tail_pos < b).sum()) if tail_pos is not None else 0
            return BucketedCSR(
                plan=plan, idx=idx_t, mask=mask_t, pos=pos_t, tail_idx=tail_idx,
                tail_off=tail_off, tail_pos=tail_pos,
                identity=_is_identity(plan, pos_t, tail_used))
        if impl == "native":
            raise RuntimeError("native packer requested but libpelfeeder.so not built "
                               "(make -C native)")
    indices = np.asarray(indices)
    offsets = offsets.astype(np.int64)
    t = offsets.shape[0]
    lens = offsets[:, 1:] - offsets[:, :-1]  # [T, B]
    blen = lens.max(axis=0)
    ls, caps = plan.bucket_ls, plan.capacities
    nk = len(ls)

    # bucket of each batch element: smallest L >= its longest bag; -1 for
    # all-empty elements; nk is the tail
    assign = np.searchsorted(np.asarray(ls), blen, side="left").astype(int)
    assign[blen == 0] = -1
    for k in range(nk):  # spill overflow, in arrival order, one bucket up
        sel = np.nonzero(assign == k)[0]
        if len(sel) > caps[k]:
            assign[sel[caps[k]:]] = k + 1
    tail_list = np.nonzero(assign == nk)[0]
    if len(tail_list) > plan.tail_bags:
        raise ValueError(
            f"bucket plan overflow ({len(tail_list)} residual bags > "
            f"tail capacity {plan.tail_bags}): re-plan with more slack "
            "or use lookup_csr"
        )

    # per-entry bag id and rank within its bag, per table
    cap_c = indices.shape[1]
    bagid = np.empty((t, cap_c), np.int64)
    rank = np.empty((t, cap_c), np.int64)
    for ti in range(t):
        n_ent = int(offsets[ti, -1])
        bagid[ti, :n_ent] = np.repeat(np.arange(b), lens[ti])
        bagid[ti, n_ent:] = b  # padding -> sentinel
        starts = np.concatenate([offsets[ti, :-1], [cap_c]])
        rank[ti] = np.arange(cap_c, dtype=np.int64) - starts[bagid[ti]]

    idx_out, mask_out, pos_out = [], [], []
    slot_of = np.full(b + 1, -1, np.int64)
    for k, l in enumerate(ls):
        bags_k = np.nonzero(assign == k)[0]
        ik = np.full((t, caps[k] * l), pad_index, np.int32)
        mk = np.zeros((t, caps[k] * l), bool)
        pk = np.full(caps[k], b, np.int32)
        pk[: len(bags_k)] = bags_k
        slot_of[:] = -1
        slot_of[bags_k] = np.arange(len(bags_k))
        for ti in range(t):
            sl = slot_of[bagid[ti]]
            put = sl >= 0
            dest = sl[put] * l + rank[ti, put]
            ik[ti, dest] = indices[ti, put]
            mk[ti, dest] = True
        idx_out.append(ik)
        mask_out.append(mk)
        pos_out.append(pk)

    tail_idx = tail_off = tail_pos = None
    if plan.tail_bags > 0:
        tail_idx = np.full((t, plan.tail_entries), pad_index, np.int32)
        tail_off = np.zeros((t, plan.tail_bags + 1), np.int32)
        tail_pos = np.full(plan.tail_bags, b, np.int32)
        tail_pos[: len(tail_list)] = tail_list
        slot_of[:] = -1
        slot_of[tail_list] = np.arange(len(tail_list))
        for ti in range(t):
            toff = np.zeros(len(tail_list) + 1, np.int64)
            np.cumsum(lens[ti, tail_list], out=toff[1:])
            if toff[-1] > plan.tail_entries:
                raise ValueError(
                    f"bucket plan overflow (table {ti}: {toff[-1]} tail "
                    f"entries > capacity {plan.tail_entries}): re-plan "
                    "with more slack"
                )
            sl = slot_of[bagid[ti]]
            put = sl >= 0
            dest = toff[sl[put]] + rank[ti, put]
            tail_idx[ti, dest] = indices[ti, put]
            tail_off[ti, 1 : len(tail_list) + 1] = toff[1:]
            tail_off[ti, len(tail_list) + 1 :] = toff[-1]

    return BucketedCSR(
        plan=plan,
        idx=tuple(idx_out),
        mask=tuple(mask_out),
        pos=tuple(pos_out),
        tail_idx=tail_idx,
        tail_off=tail_off,
        tail_pos=tail_pos,
        identity=_is_identity(plan, pos_out, len(tail_list)),
    )


def _is_identity(plan: LengthBucketPlan, pos, tail_used: int) -> bool:
    """One bucket with room for the batch, no tail, slot j holding batch
    element j."""
    b, caps = plan.batch, plan.capacities
    nonzero = [k for k in range(len(caps)) if caps[k]]
    return bool(
        not tail_used
        and len(nonzero) == 1
        and caps[nonzero[0]] >= b
        and np.array_equal(pos[nonzero[0]][:b], np.arange(b))
    )
