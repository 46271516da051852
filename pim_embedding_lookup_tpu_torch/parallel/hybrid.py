"""Hybrid embedding collection: one-hot matmuls for small tables, fused
gather+pool for big ones.

The counterpart of ``pim_embedding_lookup_tpu.parallel.hybrid`` (dense
lookup, no routing, no hot cache).  Tables with at most ``MXU_THRESHOLD``
rows form the small set: each is padded to a power-of-two bucket, equal
buckets lie side by side, and each bucket pools as one batched product of a
bf16 one-hot with the bf16 weights, accumulated in f32, as in the JAX
package.  The rest form the big set, an EmbeddingCollection whose lookup
runs the gather+pool kernel on the card.

Params are a dict ``{"small": [R_s, D] | None, "big": [S, W] | None}``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..config import ShardingPolicy, TableConfig
from ..device import resolve_device
from ..ops.ragged import segment_ids_from_offsets
from .collection import _NEG_INF, EmbeddingCollection, _csr_counts, _finish_combiner
from .planner import FusedLayout

# The JAX package's split between the two sets, kept so that layouts match.
MXU_THRESHOLD = 8192

# (row_start, padded_rows, pos_lo, pos_hi): small-set members
# [pos_lo, pos_hi) share bucket size padded_rows starting at fused row_start.
Bucket = tuple[int, int, int, int]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _plan_small_bucketed(
    tables: Sequence[TableConfig], small_ids: Sequence[int], num_shards: int
) -> tuple[tuple[int, ...], FusedLayout, tuple[Bucket, ...]]:
    """Order small tables by bucket size, pad each to its bucket, and lay
    them out contiguously so each bucket's weights are one view
    [G, n_pad, D] of the fused tensor."""
    dim = tables[small_ids[0]].dim
    npad = {i: max(8, _next_pow2(tables[i].num_rows)) for i in small_ids}
    order = tuple(sorted(small_ids, key=lambda i: (npad[i], i)))
    offsets, rows, buckets = [], [], []
    acc = 0
    for pos, i in enumerate(order):
        if buckets and buckets[-1][1] == npad[i]:
            s, n, lo, hi = buckets[-1]
            buckets[-1] = (s, n, lo, hi + 1)
        else:
            buckets.append((acc, npad[i], pos, pos + 1))
        offsets.append(acc)
        rows.append(tables[i].num_rows)
        acc += npad[i]
    layout = FusedLayout(
        policy=ShardingPolicy.REPLICATE,
        dim=dim,
        num_shards=num_shards,
        row_offsets=tuple(offsets),
        table_rows=tuple(rows),
        total_rows=acc,
        pack=1,
    )
    return order, layout, tuple(buckets)


@dataclasses.dataclass(frozen=True)
class HybridEmbeddingCollection:
    """Two sub-collections plus the routing back to the caller's table
    order."""

    tables: tuple[TableConfig, ...]
    small: EmbeddingCollection | None
    big: EmbeddingCollection | None
    small_ids: tuple[int, ...]  # original table indices, in small-set order
    big_ids: tuple[int, ...]
    perm: tuple[int, ...]  # position of original table t in concat(small, big)
    device: torch.device
    buckets: tuple[Bucket, ...] = ()
    # small_ids, big_ids and perm on the device, so that a lookup copies
    # nothing from the host
    _index: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_index", {
            name: torch.tensor(getattr(self, name), dtype=torch.long,
                               device=self.device)
            for name in ("small_ids", "big_ids", "perm")
        })

    @staticmethod
    def create(
        tables: Sequence[TableConfig],
        policy: ShardingPolicy = ShardingPolicy.AUTO,
        *,
        device=None,
    ) -> "HybridEmbeddingCollection":
        """Tables of at most MXU_THRESHOLD rows go to the small set; the big
        set is lane-packed where its dim allows."""
        device = resolve_device(device)
        small_raw = [i for i, t in enumerate(tables) if t.num_rows <= MXU_THRESHOLD]
        big_ids = tuple(i for i, t in enumerate(tables) if t.num_rows > MXU_THRESHOLD)
        small = None
        small_ids: tuple[int, ...] = ()
        buckets: tuple[Bucket, ...] = ()
        if small_raw:
            small_ids, lay, buckets = _plan_small_bucketed(tables, small_raw, 1)
            small = EmbeddingCollection(layout=lay, device=device)
        big = (
            EmbeddingCollection.create(
                [tables[i] for i in big_ids], policy, packed="auto",
                device=device,
            )
            if big_ids
            else None
        )
        order = list(small_ids) + list(big_ids)
        perm = tuple(order.index(t) for t in range(len(tables)))
        return HybridEmbeddingCollection(
            tables=tuple(tables),
            small=small,
            big=big,
            small_ids=small_ids,
            big_ids=big_ids,
            perm=perm,
            device=device,
            buckets=buckets,
        )

    # -- params -------------------------------------------------------------

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        return {
            "small": None if self.small is None else self.small.init(generator, dtype),
            "big": None if self.big is None else self.big.init(generator, dtype),
        }

    def device_put_tables(self, host_tables) -> dict:
        return {
            "small": None if self.small is None else self.small.device_put_tables(
                [host_tables[i] for i in self.small_ids]),
            "big": None if self.big is None else self.big.device_put_tables(
                [host_tables[i] for i in self.big_ids]),
        }

    # -- lookup -------------------------------------------------------------

    def lookup(
        self,
        params: dict,
        indices: torch.Tensor,  # [T, B*L]
        mask: torch.Tensor,  # [T, B*L]
        *,
        batch_size: int,
        combiner: str = "sum",  # "sum" | "mean" | "max"
    ) -> torch.Tensor:  # [B, T, D] f32
        """Pooled lookup in the caller's table order."""
        mask = mask.to(torch.bool)
        parts = []
        if self.small is not None:
            sel = self._index["small_ids"]
            parts.append(_mxu_pooled_lookup(
                params["small"], self.buckets, indices[sel], mask[sel],
                batch_size=batch_size, combiner=combiner,
            ))
        if self.big is not None:
            sel = self._index["big_ids"]
            parts.append(self.big.lookup(
                params["big"], indices[sel], mask[sel], batch_size=batch_size,
                combiner=combiner,
            ))
        pooled = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return pooled[:, self._index["perm"]]

    def lookup_csr(
        self,
        params: dict,
        indices: torch.Tensor,  # [T, C]
        offsets: torch.Tensor,  # [T, B+1]
        *,
        combiner: str = "sum",
        data_sharded: bool = False,
        routed: bool = False,
        capacity_factor: float | None = None,
        return_stats: bool = False,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:  # [B, T, D] f32
        """Pooled lookup over ragged (CSR) bags in the caller's table order,
        with EmbeddingCollection.lookup_csr's contract: the small set pools
        its bucketed one-hot rows by a segment reduce, the big set runs the
        CSR kernel (K2).  ``return_stats`` adds the big set's count of
        dropped entries, which is 0 off the routed path."""
        if routed:
            raise NotImplementedError(
                "routed lookup_csr needs the multi-device port (ROADMAP.md)")
        parts = []
        if self.small is not None:
            sel = self._index["small_ids"]
            parts.append(_mxu_csr_lookup(
                params["small"], self.buckets, indices[sel], offsets[sel],
                combiner=combiner,
            ))
        if self.big is not None:
            sel = self._index["big_ids"]
            parts.append(self.big.lookup_csr(
                params["big"], indices[sel], offsets[sel], combiner=combiner,
                data_sharded=data_sharded, capacity_factor=capacity_factor,
            ))
        pooled = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        out = pooled[:, self._index["perm"]]
        if return_stats:
            return out, torch.zeros((), dtype=torch.int32, device=out.device)
        return out


# -- bucketed one-hot products -------------------------------------------------


def _bucket_entry_rows(fused, bucket, indices, mask):
    """One bucket's per-entry rows: [G, C, D] f32 = onehot(ids) @ W with
    both operands in bf16, as the JAX package computes them, so each row
    equals f32(bf16(w[id])).

    The one-hot is written straight into bf16 (a scatter of the mask into
    zeros): masked entries give all-zero one-hot rows and exact zeros."""
    start, npad, lo, hi = bucket
    g = hi - lo
    d = fused.shape[-1]
    w = fused[start : start + g * npad].reshape(g, npad, d).to(torch.bfloat16)
    ids = indices[lo:hi].long()  # [G, C]
    mk = mask[lo:hi]
    oh = torch.zeros(g, ids.shape[1], npad, dtype=torch.bfloat16,
                     device=fused.device)
    oh.scatter_(2, torch.where(mk, ids, 0)[..., None],
                mk[..., None].to(torch.bfloat16))
    # one nonzero term per output: the bf16 product is exact
    return torch.bmm(oh, w).float(), mk


def _mxu_pooled_lookup(fused, buckets, indices, mask, *, batch_size,
                       combiner="sum"):
    """Bucketed one-hot x weights batched products, one per distinct bucket
    size.  Returns [B, Ts, D] f32."""
    t, c = indices.shape
    pooling = c // batch_size
    outs = []
    for bucket in buckets:
        rows, mk = _bucket_entry_rows(fused, bucket, indices, mask)
        g, _, d = rows.shape
        rows = rows.reshape(g, batch_size, pooling, d)
        if combiner == "max":
            rows = torch.where(mk.reshape(g, batch_size, pooling, 1), rows, _NEG_INF)
            outs.append(rows.amax(dim=2))
        else:
            outs.append(rows.sum(dim=2))
    pooled = torch.cat(outs, dim=0).transpose(0, 1)  # [B, Ts, D]
    if combiner == "sum":
        return pooled
    return _finish_combiner(combiner, pooling, pooled, mask)


def _mxu_csr_lookup(fused, buckets, indices, offsets, *, combiner="sum"):
    """CSR form of the small set: each bucket's per-entry one-hot rows, then
    a segment reduce over the fused bag ids g*(B+1) + min(seg, B) (bag B
    takes the padding and is dropped).  Returns [B, Ts, D] f32."""
    t, c = indices.shape
    b = offsets.shape[1] - 1
    seg = segment_ids_from_offsets(offsets, c).long()  # [Ts, C]
    valid = seg < b
    outs = []
    for bucket in buckets:
        _, _, lo, hi = bucket
        g = hi - lo
        rows, mk = _bucket_entry_rows(fused, bucket, indices, valid)
        d = rows.shape[-1]
        base = torch.arange(g, device=seg.device)[:, None] * (b + 1)
        fseg = (base + seg[lo:hi]).reshape(-1)
        flat = rows.reshape(g * c, d)
        if combiner == "max":
            flat = torch.where(mk.reshape(-1, 1), flat, _NEG_INF)
            pooled = torch.full((g * (b + 1), d), _NEG_INF, device=flat.device)
            pooled.scatter_reduce_(0, fseg[:, None].expand(-1, d), flat, "amax")
        else:
            pooled = torch.zeros(g * (b + 1), d, device=flat.device)
            pooled.index_add_(0, fseg, flat)
        outs.append(pooled.reshape(g, b + 1, d)[:, :b])
    pooled = torch.cat(outs, dim=0).transpose(0, 1)  # [B, Ts, D]
    if combiner == "sum":
        return pooled
    counts = _csr_counts(offsets)
    if combiner == "mean":
        return pooled / counts.clamp(min=1)
    return torch.where(counts > 0, pooled, 0.0)
