"""Runtime configuration: tables, queries and the DLRM architecture.

The same dataclasses and presets as ``pim_embedding_lookup_tpu.config``, with
the storage dtype held as a numpy dtype name so that byte counts (and the
planner's AUTO decision, which reads them) come out the same.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class Combiner(str, enum.Enum):
    """Bag pooling mode."""

    SUM = "sum"
    MEAN = "mean"
    MAX = "max"


class ShardingPolicy(str, enum.Enum):
    """How a table is laid out over the model axis."""

    REPLICATE = "replicate"  # whole table on every model-shard
    ROW = "row"              # contiguous row ranges per shard
    ROW_HASH = "row_hash"    # strided rows: owner = id % shards
    COLUMN = "column"        # dim split per shard
    TABLE_WISE = "table_wise"  # whole tables bin-packed over shards
    AUTO = "auto"            # planner decides


class LookupImpl(str, enum.Enum):
    """Which kernel computes gather+pool on a shard."""

    JNP = "jnp"
    ONEHOT = "onehot"
    PALLAS = "pallas"
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One embedding table."""

    num_rows: int
    dim: int
    name: str = ""
    combiner: Combiner = Combiner.SUM
    dtype: str = "float32"  # numpy dtype name of the storage
    sharding: ShardingPolicy = ShardingPolicy.AUTO

    @property
    def bytes(self) -> int:
        return self.num_rows * self.dim * np.dtype(self.dtype).itemsize


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Static query shape: B bags of at most L ids each."""

    batch_size: int
    max_indices_per_batch: int

    @property
    def capacity(self) -> int:
        """Flat padded index capacity per table."""
        return self.batch_size * self.max_indices_per_batch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: ``data`` is the batch axis, ``model`` the
    table-sharding axis."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Full DLRM architecture (dense + sparse halves)."""

    dense_dim: int
    mlp_bot: Sequence[int]
    mlp_top: Sequence[int]
    tables: Sequence[TableConfig]
    interaction: str = "dot"
    interact_itself: bool = False
    sigmoid_top: bool = True

    @property
    def sparse_dim(self) -> int:
        dims = {t.dim for t in self.tables}
        if len(dims) != 1:
            raise ValueError(f"DLRM dot interaction needs equal dims, got {dims}")
        return next(iter(dims))

    @property
    def num_tables(self) -> int:
        return len(self.tables)


# Criteo Kaggle categorical cardinalities (facebookresearch/dlrm processed
# kaggleAdDisplayChallenge counts).
KAGGLE_TABLE_ROWS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)


def kaggle_config(dim: int = 16) -> DLRMConfig:
    """Criteo-Kaggle DLRM: 26 tables of dim 16, bot 13-512-256-64-16,
    top 512-256-1."""
    tables = tuple(
        TableConfig(num_rows=n, dim=dim, name=f"cat_{i}")
        for i, n in enumerate(KAGGLE_TABLE_ROWS)
    )
    return DLRMConfig(
        dense_dim=13,
        mlp_bot=(512, 256, 64, dim),
        mlp_top=(512, 256, 1),
        tables=tables,
    )


def random_config(
    num_tables: int = 32, rows: int = 500_000, dim: int = 64
) -> DLRMConfig:
    """32 tables x 500k rows x dim 64."""
    tables = tuple(
        TableConfig(num_rows=rows, dim=dim, name=f"rand_{i}")
        for i in range(num_tables)
    )
    return DLRMConfig(
        dense_dim=13,
        mlp_bot=(512, 256, dim),
        mlp_top=(512, 256, 1),
        tables=tables,
    )


def toy_config(num_tables: int = 9, rows: int = 64, dim: int = 64) -> DLRMConfig:
    """9 tables, dim 64, tiny rows."""
    tables = tuple(
        TableConfig(num_rows=rows, dim=dim, name=f"toy_{i}")
        for i in range(num_tables)
    )
    return DLRMConfig(
        dense_dim=4,
        mlp_bot=(8, dim),
        mlp_top=(16, 1),
        tables=tables,
    )


def loadgen_config(num_tables: int = 8, rows: int = 50_000, dim: int = 16):
    """Standalone lookup-benchmark shapes: 8 tables x 50k rows, 128 bags of
    32 ids."""
    tables = tuple(
        TableConfig(num_rows=rows, dim=dim, name=f"lg_{i}")
        for i in range(num_tables)
    )
    return tables, QueryConfig(batch_size=128, max_indices_per_batch=32)
