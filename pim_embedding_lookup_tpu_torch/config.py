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


INTERACTIONS = ("dot", "dcn")


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Full DLRM architecture (dense + sparse halves).

    ``interaction``: ``"dot"``, the pairwise dots of the dense vector and
    the pooled vectors (dlrm's ``--arch-interaction-op=dot``), or ``"dcn"``,
    a low-rank cross network of ``dcn_num_layers`` layers at rank
    ``dcn_low_rank_dim`` over their concatenation (torchrec's
    ``InteractionDCNArch``, MLPerf DLRM-DCNv2)."""

    dense_dim: int
    mlp_bot: Sequence[int]
    mlp_top: Sequence[int]
    tables: Sequence[TableConfig]
    interaction: str = "dot"
    interact_itself: bool = False
    sigmoid_top: bool = True
    dcn_num_layers: int = 0
    dcn_low_rank_dim: int = 0

    def __post_init__(self):
        if self.interaction not in INTERACTIONS:
            raise ValueError(f"interaction must be one of {INTERACTIONS}, "
                             f"got {self.interaction!r}")
        if self.interaction == "dcn" and (self.dcn_num_layers < 1 or self.dcn_low_rank_dim < 1):
            raise ValueError("a dcn interaction needs dcn_num_layers >= 1 and "
                             f"dcn_low_rank_dim >= 1, got {self.dcn_num_layers} "
                             f"and {self.dcn_low_rank_dim}")

    @property
    def sparse_dim(self) -> int:
        dims = {t.dim for t in self.tables}
        if len(dims) != 1:
            raise ValueError(f"DLRM needs tables of one dim, got {dims}")
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


# MLPerf DLRM-DCNv2 (mlcommons/training recommendation_v2/torchrec_dlrm):
# the Criteo 1TB tables with ids hashed to at most 40,000,000 rows, and the
# fixed multi-hot bag length of each table (its synthetic multi-hot set)
DCNV2_TABLE_ROWS = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36,
)
DCNV2_BAG_LENGTHS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                     10, 3, 1, 1)
DCNV2_MAX_ROWS = 40_000_000


def mlperf_dcnv2_config(row_shards: int = 1) -> DLRMConfig:
    """MLPerf DLRM-DCNv2: 26 tables of dim 128, bot 13-512-256-128, 3
    low-rank cross layers at rank 512 over the 27 x 128 concatenation, top
    1024-1024-512-256-1.  ``row_shards``: the cards that split each
    40,000,000-row table by rows; the tables hold one card's share of those
    rows (the others stay whole)."""
    if row_shards < 1 or DCNV2_MAX_ROWS % row_shards:
        raise ValueError(f"row_shards must divide {DCNV2_MAX_ROWS}, got {row_shards}")
    tables = tuple(
        TableConfig(num_rows=n // row_shards if n == DCNV2_MAX_ROWS else n, dim=128,
                    name=f"cat_{i}")
        for i, n in enumerate(DCNV2_TABLE_ROWS)
    )
    return DLRMConfig(
        dense_dim=13,
        mlp_bot=(512, 256, 128),
        mlp_top=(1024, 1024, 512, 256, 1),
        tables=tables,
        interaction="dcn",
        dcn_num_layers=3,
        dcn_low_rank_dim=512,
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
