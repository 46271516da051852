"""Synthetic query and batch generation, on the host (numpy).

The counterpart of ``pim_embedding_lookup_tpu.data.synthetic``: the same
draws in the same order from the same seeds, so that both packages yield
the same arrays.  Uniform ids, as the reference's standalone load generator
and dlrm's ``--data-generation=random`` draw them, or zipf (power-law) ids,
the skew that stresses row sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from ..config import DLRMConfig, QueryConfig, TableConfig


@dataclasses.dataclass
class QueryGenerator:
    """Padded multi-hot queries for a table collection.

    distribution: "uniform" | "zipf" (``zipf_alpha`` sets the skew)."""

    tables: Sequence[TableConfig]
    query: QueryConfig
    distribution: str = "uniform"
    zipf_alpha: float = 1.05
    seed: int = 0
    fixed_length: bool = True  # every bag padded to L, as the reference pads them

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._t = len(self.tables)

    def _draw_indices(self, num_rows: int, shape) -> np.ndarray:
        if self.distribution == "uniform":
            return self._rng.integers(0, num_rows, size=shape, dtype=np.int64)
        if self.distribution == "zipf":
            z = self._rng.zipf(self.zipf_alpha, size=shape)
            return np.minimum(z - 1, num_rows - 1)
        raise ValueError(self.distribution)

    def _draw_all(self, b: int, l: int) -> np.ndarray:
        """[T, B, L] int32: the native generator where its library loads
        (seeded from this generator's rng), numpy otherwise."""
        from ..utils import native

        if native.available():
            out = native.gen_query(
                np.asarray([t.num_rows for t in self.tables], np.int64),
                b, l,
                distribution=self.distribution,
                alpha=self.zipf_alpha,
                seed=int(self._rng.integers(0, 2**31 - 1)),
            )
            return out.astype(np.int32)
        return np.stack(
            [self._draw_indices(t.num_rows, (b, l)) for t in self.tables]
        ).astype(np.int32)

    def next_query(self) -> tuple[np.ndarray, np.ndarray]:
        """-> indices [T, B*L] int32, mask [T, B*L] bool, bag-major (the
        dense wire of ``EmbeddingCollection.lookup``)."""
        b, l = self.query.batch_size, self.query.max_indices_per_batch
        idx = self._draw_all(b, l)
        if self.fixed_length:
            mask = np.ones((self._t, b, l), dtype=bool)
        else:
            lengths = self._rng.integers(1, l + 1, size=(self._t, b))
            mask = np.arange(l)[None, None, :] < lengths[..., None]
        return idx.reshape(self._t, b * l), mask.reshape(self._t, b * l)

    def queries(self, n: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        for _ in range(n):
            yield self.next_query()


def random_tables(
    tables: Sequence[TableConfig], seed: int = 0, scale: float = 1.0
) -> list[np.ndarray]:
    """Per-table f32 weights uniform in [0, scale)."""
    rng = np.random.default_rng(seed)
    return [(rng.random((t.num_rows, t.dim), dtype=np.float32) * scale) for t in tables]


@dataclasses.dataclass
class SyntheticDLRMBatches:
    """Random DLRM training batches (dense [B, dense_dim] f32, indices and
    mask [T, B*L], labels [B] f32 in {0, 1}), dlrm's
    ``--data-generation=random``."""

    config: DLRMConfig
    batch_size: int
    indices_per_lookup: int
    num_batches: int
    seed: int = 0
    distribution: str = "uniform"

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        gen = QueryGenerator(
            self.config.tables,
            QueryConfig(self.batch_size, self.indices_per_lookup),
            distribution=self.distribution,
            seed=self.seed + 1,
        )
        for _ in range(self.num_batches):
            dense = rng.random((self.batch_size, self.config.dense_dim)).astype(np.float32)
            idx, mask = gen.next_query()
            labels = (rng.random(self.batch_size) < 0.5).astype(np.float32)
            yield dense, idx, mask, labels
