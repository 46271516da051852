"""Table placement planner: decides how a collection of same-dim tables is
laid out over the model axis and builds its fused-storage layout.

* REPLICATE  — every model-shard holds all rows.
* ROW        — fused rows split equally across shards.
* ROW_HASH   — strided rows, owner = fused id % shards.
* COLUMN     — embedding dim split across shards.
* TABLE_WISE — whole tables bin-packed onto shards, padded so that each
               table lands wholly on one shard.

The layouts equal those of ``pim_embedding_lookup_tpu.parallel.planner``
field for field, so fused storage converts between the two packages as is.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..config import ShardingPolicy, TableConfig

# AUTO thresholds
REPLICATE_MAX_BYTES = 128 << 20  # collections under 128MB replicate
COLUMN_MIN_DIM_PER_SHARD = 128


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """Fused storage plan for a collection of same-dim tables.

    Tables live stacked in one [total_rows, dim] array; table t's row r is
    fused row ``row_offsets[t] + r``.  ``total_rows`` is padded so the shards
    divide it evenly.

    When ``pack > 1`` the storage is ``[total_rows/pack, dim*pack]``: fused
    row g lives at storage row ``g // pack``, lane group ``g % pack``.  That
    is the same row-major bytes as ``[total_rows, dim]``, so the port's
    kernels address dim-wide rows directly whatever the pack.
    """

    policy: ShardingPolicy
    dim: int
    num_shards: int
    row_offsets: tuple[int, ...]  # [T] fused start row per table
    table_rows: tuple[int, ...]  # [T] logical rows per table
    total_rows: int  # padded fused row count
    pack: int = 1  # fused rows per 128-wide storage row

    @property
    def rows_per_shard(self) -> int:
        return self.total_rows // self.num_shards

    @property
    def num_tables(self) -> int:
        return len(self.row_offsets)

    @property
    def storage_rows(self) -> int:
        return self.total_rows // self.pack

    @property
    def storage_width(self) -> int:
        return self.dim * self.pack


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_pack(dim: int, policy: ShardingPolicy, packed) -> int:
    """Pack factor for (dim, policy).  ``packed``: False, True or "auto".

    Packing needs 128 % dim == 0 with dim < 128, and is incompatible with
    COLUMN sharding."""
    supported = dim < 128 and 128 % dim == 0 and policy != ShardingPolicy.COLUMN
    if packed is True:
        if not supported:
            raise ValueError(
                f"packed storage unsupported for dim={dim}, policy={policy}"
            )
        return 128 // dim
    if packed == "auto":
        return 128 // dim if supported else 1
    return 1


def plan(
    tables: Sequence[TableConfig],
    num_shards: int,
    policy: ShardingPolicy = ShardingPolicy.AUTO,
    packed: bool | str = False,
) -> FusedLayout:
    dims = {t.dim for t in tables}
    if len(dims) != 1:
        raise ValueError(f"one collection per dim; got dims {dims}")
    dim = next(iter(dims))
    itemsize = np.dtype(tables[0].dtype).itemsize
    total_bytes = sum(t.num_rows for t in tables) * dim * itemsize

    if policy == ShardingPolicy.AUTO:
        if num_shards == 1 or total_bytes <= REPLICATE_MAX_BYTES:
            policy = ShardingPolicy.REPLICATE
        elif dim % num_shards == 0 and dim // num_shards >= COLUMN_MIN_DIM_PER_SHARD:
            policy = ShardingPolicy.COLUMN
        else:
            policy = ShardingPolicy.ROW_HASH

    pack = resolve_pack(dim, policy, packed)
    # shard boundaries land on 8-row storage boundaries
    align = 8 * pack

    table_rows = tuple(t.num_rows for t in tables)

    if policy == ShardingPolicy.TABLE_WISE:
        return _plan_table_wise(table_rows, dim, num_shards, pack, align)

    offsets, acc = [], 0
    for t in tables:
        offsets.append(acc)
        acc += t.num_rows
    if policy in (ShardingPolicy.ROW, ShardingPolicy.ROW_HASH):
        total = _round_up(acc, num_shards * align)
    else:
        total = _round_up(acc, align)
    if policy == ShardingPolicy.COLUMN and dim % num_shards != 0:
        raise ValueError(f"COLUMN sharding needs model|{num_shards} to divide dim={dim}")
    return FusedLayout(
        policy=policy,
        dim=dim,
        num_shards=num_shards,
        row_offsets=tuple(offsets),
        table_rows=table_rows,
        total_rows=total,
        pack=pack,
    )


def _plan_table_wise(
    table_rows: tuple[int, ...], dim: int, num_shards: int,
    pack: int = 1, align: int = 8,
) -> FusedLayout:
    """Greedy bin-pack of whole tables onto shards by row count, then every
    shard padded to the largest, so that an equal row split lands each table
    wholly on its shard."""
    order = sorted(range(len(table_rows)), key=lambda i: -table_rows[i])
    bins: list[list[int]] = [[] for _ in range(num_shards)]
    loads = [0] * num_shards
    for i in order:
        s = int(np.argmin(loads))
        bins[s].append(i)
        loads[s] += table_rows[i]
    rows_per_shard = _round_up(max(loads), align)
    offsets = [0] * len(table_rows)
    for s, members in enumerate(bins):
        acc = s * rows_per_shard
        for i in members:
            offsets[i] = acc
            acc += table_rows[i]
    return FusedLayout(
        policy=ShardingPolicy.TABLE_WISE,
        dim=dim,
        num_shards=num_shards,
        row_offsets=tuple(offsets),
        table_rows=table_rows,
        total_rows=rows_per_shard * num_shards,
        pack=pack,
    )
