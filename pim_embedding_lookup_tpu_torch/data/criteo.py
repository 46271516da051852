"""Criteo Kaggle (Display Advertising Challenge) data, on the host (numpy).

The counterpart of ``pim_embedding_lookup_tpu.data.criteo``.  It reads the
facebookresearch/dlrm preprocessed npz:

    X_int   [N, 13]  int   counts (log1p'd at load time)
    X_cat   [N, 26]  int   categorical ids (taken modulo each table's rows)
    y       [N]      0/1   click labels
    counts  [26]     table cardinalities

or parses the raw tab-separated ``train.txt`` (label, 13 ints, 26 hex
categorical ids hashed modulo ``hash_mod``), with the native parser where
its library loads and in Python otherwise.  Criteo Kaggle is single-hot:
every bag has one id, so batches have L=1 and an all-ones mask.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from ..config import DLRMConfig, TableConfig

NUM_DENSE = 13
NUM_CAT = 26
_HASH_BITS = 0xFFFFFFFF


@dataclasses.dataclass
class CriteoKaggle:
    """In-memory Criteo Kaggle rows; ``split`` keeps the last 1/7 (the
    last day) for testing, as dlrm's ``data_split='train'`` does."""

    x_int: np.ndarray  # [N, 13] float32 (log1p transformed)
    x_cat: np.ndarray  # [N, 26] int32
    y: np.ndarray  # [N] float32
    counts: np.ndarray  # [26] int64

    @staticmethod
    def load_npz(path: str, max_rows: int | None = None) -> "CriteoKaggle":
        with np.load(path) as z:
            x_int = z["X_int"][:max_rows]
            x_cat = z["X_cat"][:max_rows]
            y = z["y"][:max_rows]
            counts = z["counts"]
        x_int = np.log1p(np.maximum(x_int, 0)).astype(np.float32)
        return CriteoKaggle(
            x_int=x_int,
            x_cat=(x_cat % counts[None, :]).astype(np.int32),
            y=y.astype(np.float32),
            counts=counts.astype(np.int64),
        )

    @staticmethod
    def parse_raw(
        path: str, max_rows: int | None = None, hash_mod: int = 1 << 20
    ) -> "CriteoKaggle":
        """Parse raw ``train.txt`` with modulo hashing: the native parser
        where its library loads, else Python."""
        from ..utils import native

        if native.available():
            with open(path, "rb") as f:
                cap = max_rows or sum(1 for _ in f)
            parsed = native.parse_criteo_raw(path, cap, hash_mod)
            if parsed is not None:
                labels_np, dense_np, cat_np = parsed
                x_int = np.log1p(np.maximum(dense_np, 0).astype(np.float32))
                counts = cat_np.max(axis=0).astype(np.int64) + 1
                return CriteoKaggle(
                    x_int=x_int,
                    x_cat=cat_np.astype(np.int32),
                    y=labels_np.astype(np.float32),
                    counts=counts,
                )
        labels, dense, cats = [], [], []
        with open(path) as f:
            for i, line in enumerate(f):
                if max_rows is not None and i >= max_rows:
                    break
                parts = line.rstrip("\n").split("\t")
                labels.append(int(parts[0]))
                dense.append([int(v) if v else 0 for v in parts[1 : 1 + NUM_DENSE]])
                cats.append([
                    (int(v, 16) & _HASH_BITS) % hash_mod if v else 0
                    for v in parts[1 + NUM_DENSE : 1 + NUM_DENSE + NUM_CAT]
                ])
        x_int = np.log1p(np.maximum(np.asarray(dense, np.float32), 0))
        x_cat = np.asarray(cats, np.int64)
        counts = x_cat.max(axis=0) + 1
        return CriteoKaggle(
            x_int=x_int.astype(np.float32),
            x_cat=x_cat.astype(np.int32),
            y=np.asarray(labels, np.float32),
            counts=counts.astype(np.int64),
        )

    def dlrm_config(self, dim: int = 16) -> DLRMConfig:
        tables = tuple(
            TableConfig(num_rows=int(n), dim=dim, name=f"cat_{i}")
            for i, n in enumerate(self.counts)
        )
        return DLRMConfig(
            dense_dim=NUM_DENSE,
            mlp_bot=(512, 256, 64, dim),
            mlp_top=(512, 256, 1),
            tables=tables,
        )

    def split(self, test_frac: float = 1 / 7) -> tuple["CriteoKaggle", "CriteoKaggle"]:
        n = len(self.y)
        cut = int(n * (1 - test_frac))
        tr = CriteoKaggle(self.x_int[:cut], self.x_cat[:cut], self.y[:cut], self.counts)
        te = CriteoKaggle(self.x_int[cut:], self.x_cat[cut:], self.y[cut:], self.counts)
        return tr, te

    def batches(
        self, batch_size: int, *, shuffle: bool = False, seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (dense [B, 13], indices [26, B], mask [26, B], labels
        [B]): the dense wire at L=1."""
        n = len(self.y)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = n - batch_size + 1 if drop_last else n
        for s in range(0, stop, batch_size):
            sel = order[s : s + batch_size]
            idx = self.x_cat[sel].T  # [26, B]
            mask = np.ones_like(idx, dtype=bool)
            yield self.x_int[sel], idx.astype(np.int32), mask, self.y[sel]


def find_dataset(paths: tuple[str, ...] = (
    "kaggleAdDisplayChallenge_processed.npz",
    os.path.expanduser("~/criteo/kaggleAdDisplayChallenge_processed.npz"),
    "/data/criteo/kaggleAdDisplayChallenge_processed.npz",
)) -> str | None:
    """The first of ``paths`` that exists, or None."""
    for p in paths:
        if os.path.exists(p):
            return p
    return None
