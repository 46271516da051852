"""Embedding collection: same-dim tables fused into one storage tensor, and
their pooled lookup.

The counterpart of ``pim_embedding_lookup_tpu.parallel.collection`` on one
device.  Queries use the dense padded form: indices and mask of shape
[T, B*L] (B*L entries per table, bag-major), and lookups return [B, T, D]
in f32 whatever the storage dtype.  On a CUDA tensor SUM and MEAN go
through the gather+pool kernel (K1); MAX is plain PyTorch, as it is XLA
work in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import ShardingPolicy, TableConfig
from ..device import resolve_device
from ..ops.gather_pool import embedding_bag_fixedl
from .planner import FusedLayout, plan

_NEG_INF = -3.0e38  # max-combiner identity


@dataclasses.dataclass(frozen=True)
class EmbeddingCollection:
    """A set of same-dim embedding tables fused into one tensor.

    Usage:
        coll = EmbeddingCollection.create(tables, device="cuda")
        fused = coll.init(generator)                # [storage_rows, width]
        pooled = coll.lookup(fused, idx, mask)      # [B, T, D]
    """

    layout: FusedLayout
    device: torch.device
    # row_offsets on the device, so that a lookup copies nothing from the
    # host (a copy from pageable memory would wait for the card)
    _row_offsets: torch.Tensor = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_row_offsets", torch.tensor(
            self.layout.row_offsets, dtype=torch.int32, device=self.device))

    @staticmethod
    def create(
        tables: Sequence[TableConfig],
        policy: ShardingPolicy = ShardingPolicy.AUTO,
        *,
        packed: bool | str = False,
        device=None,
    ) -> "EmbeddingCollection":
        """One device, so one model shard.  ``packed``: lane-pack storage
        for dim < 128 (False | True | "auto"), see FusedLayout.pack."""
        return EmbeddingCollection(
            plan(tables, 1, policy, packed), resolve_device(device)
        )

    # -- storage ------------------------------------------------------------

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Fused storage with per-table uniform(-1/sqrt(n), 1/sqrt(n)) rows,
        the dlrm EmbeddingBag init, drawn in place table by table (no
        transient beyond the output).  Padding rows are zero."""
        lay = self.layout
        fused = torch.zeros(lay.total_rows, lay.dim, dtype=dtype,
                            device=self.device)
        # one shard: every policy stores table t at rows [off, off + rows)
        for off, rows in zip(lay.row_offsets, lay.table_rows):
            bound = 1.0 / np.sqrt(rows)
            fused[off : off + rows].uniform_(-bound, bound, generator=generator)
        return fused.view(lay.storage_rows, lay.storage_width)

    def fused_host_array(self, host_tables: Sequence[np.ndarray]) -> np.ndarray:
        """Per-table host weights -> the fused [storage_rows, storage_width]
        f32 numpy array in this layout's storage order (ROW_HASH striding and
        lane packing applied)."""
        lay = self.layout
        fused = np.zeros((lay.total_rows, lay.dim), np.float32)
        for arr, off, rows in zip(host_tables, lay.row_offsets, lay.table_rows):
            if arr.shape != (rows, lay.dim):
                raise ValueError(f"table shape {arr.shape} != {(rows, lay.dim)}")
            fused[off : off + rows] = arr
        if lay.policy == ShardingPolicy.ROW_HASH:
            fused = fused[self._row_hash_perm()]
        return fused.reshape(lay.storage_rows, lay.storage_width)

    def device_put_tables(self, host_tables: Sequence[np.ndarray]) -> torch.Tensor:
        """Load pre-existing per-table weights onto this collection's device."""
        return torch.from_numpy(self.fused_host_array(host_tables)).to(self.device)

    def unfuse_host(self, fused) -> list[np.ndarray]:
        """Inverse of fused_host_array: fused storage (tensor or numpy) ->
        per-table [rows, dim] numpy weights in table order."""
        lay = self.layout
        if isinstance(fused, torch.Tensor):
            fused = fused.detach().float().cpu().numpy()
        arr = np.asarray(fused).reshape(-1, lay.dim)
        if lay.policy == ShardingPolicy.ROW_HASH:
            perm = self._row_hash_perm()
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            arr = arr[inv]
        return [arr[off : off + rows]
                for off, rows in zip(lay.row_offsets, lay.table_rows)]

    def _row_hash_perm(self) -> np.ndarray:
        """Strided placement: shard s's local row j holds fused row j*m+s."""
        m, rps = self.layout.num_shards, self.layout.rows_per_shard
        return (np.arange(rps)[None, :] * m + np.arange(m)[:, None]).reshape(-1)

    # -- lookup -------------------------------------------------------------

    def globalize(self, indices: torch.Tensor) -> torch.Tensor:
        """Per-table local ids [T, C] -> fused row ids."""
        return indices + self._row_offsets.to(indices.dtype)[:, None]

    def lookup(
        self,
        fused_table: torch.Tensor,
        indices: torch.Tensor,  # [T, B*L] local ids
        mask: torch.Tensor,  # [T, B*L] bool
        *,
        batch_size: int | None = None,
        combiner: str = "sum",  # "sum" | "mean" | "max"
    ) -> torch.Tensor:  # [B, T, D] f32
        """Pooled lookup.  Empty bags pool to 0 for every combiner."""
        if self.layout.policy != ShardingPolicy.REPLICATE:
            raise NotImplementedError(
                f"lookup for policy {self.layout.policy.value}: only REPLICATE "
                "is ported (the other policies are listed in ROADMAP.md)"
            )
        t, c = indices.shape
        b = batch_size if batch_size is not None else c
        if c % b:
            raise ValueError(f"capacity {c} not divisible by batch {b}")
        pooling = c // b
        mask = mask.to(torch.bool)
        g_idx = self.globalize(indices.to(torch.int32))
        if combiner == "max":
            return _max_pool(fused_table, self.layout.dim, g_idx, mask, pooling)
        if combiner not in ("sum", "mean"):
            raise ValueError(f"unknown combiner {combiner!r}")
        out = embedding_bag_fixedl(
            fused_table, self.layout.dim, g_idx.reshape(-1),
            pooling=pooling, batch_size=t * b, mask=mask.reshape(-1),
        )
        pooled = out.reshape(t, b, -1).transpose(0, 1)
        if combiner == "sum":
            return pooled
        return _finish_combiner("mean", pooling, pooled, mask)


def _finish_combiner(combiner, pooling, pooled, mask):
    """MEAN/MAX finish on [B, T, D]: MEAN divides by max(count, 1), MAX
    sends empty bags to 0."""
    t, c = mask.shape
    counts = mask.reshape(t, c // pooling, pooling).sum(dim=-1)  # [T, B]
    counts = counts.transpose(0, 1)[..., None]  # [B, T, 1]
    if combiner == "mean":
        return pooled / counts.clamp(min=1)
    return torch.where(counts > 0, pooled, 0.0)


def _max_pool(fused_table, dim, g_idx, mask, pooling):
    """Masked MAX over each bag, one table at a time so that the gathered
    rows never exceed [B*L, D]."""
    rows_all = fused_table.reshape(-1, dim)
    per_table = []
    for ids, keep in zip(g_idx, mask):
        rows = rows_all[torch.where(keep, ids, 0).long()].float()
        rows = torch.where(keep[:, None], rows, _NEG_INF)
        per_table.append(rows.reshape(-1, pooling, dim).amax(dim=1))
    pooled = torch.stack(per_table, dim=1)  # [B, T, D]
    return _finish_combiner("max", pooling, pooled, mask)
